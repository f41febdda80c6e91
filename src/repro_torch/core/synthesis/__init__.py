from .detect import DetectionResult, ShufflePair, detect  # noqa: F401
