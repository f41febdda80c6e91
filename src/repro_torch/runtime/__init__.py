from .health import ElasticPlan, Heartbeat, StragglerDetector, plan_elastic  # noqa: F401
