from .pipeline import DataConfig, TokenPipeline  # noqa: F401
