from .step import generate, make_decode_step, make_prefill_step  # noqa: F401
