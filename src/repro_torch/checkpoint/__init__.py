from .store import CheckpointStore, tree_flatten, tree_unflatten  # noqa: F401
