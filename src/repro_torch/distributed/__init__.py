"""Sequence-parallel attention, pipeline stages and gradient compression
over a ``DeviceMesh`` (mirrors ``src/repro/distributed``)."""

from .compression import ef_compressed_mean, pod_compressed_mean  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
