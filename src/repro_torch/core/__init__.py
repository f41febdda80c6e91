"""Middle-end of the port: PTX IR and its parser and printer, symbolic
terms, both emulators, detection and codegen, the pass manager and its
cache tiers, the target profiles, the driver facade and the stencil
frontend, each a copy of its ``repro.core`` namesake.

The public surface is the driver facade (``repro_torch.core.driver.Compiler``);
it is re-exported lazily so ``import repro_torch.core`` stays import-light.
"""


def __getattr__(name):
    if name == "driver":
        import importlib
        return importlib.import_module(".driver", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
