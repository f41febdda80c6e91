"""Middle-end of the port: PTX IR, symbolic terms, emulator, detection,
and the stencil frontend, each a copy of its ``repro.core`` namesake."""
