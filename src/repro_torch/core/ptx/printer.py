"""Mirrors ``src/repro/core/ptx/printer.py`` (only the imports differ).

Printer: :mod:`repro.core.ptx.ir` -> assembler-readable PTX text."""

from __future__ import annotations

from ..targets import default_target
from .ir import Instr, Kernel, Label, Module


def print_kernel(kernel: Kernel) -> str:
    lines = []
    params = ", ".join(f".param .{t} {n}" for n, t in kernel.params)
    lines.append(f".visible .entry {kernel.name}({params})")
    lines.append("{")
    for ptype, prefix, count in kernel.decls:
        if count > 0:
            lines.append(f"  .reg .{ptype} %{prefix}<{count}>;")
        else:
            lines.append(f"  .reg .{ptype} {prefix};")
    for stmt in kernel.body:
        if isinstance(stmt, Label):
            lines.append(f"{stmt.name}:")
        else:
            lines.append(f"  {stmt}")
    lines.append("}")
    return "\n".join(lines) + "\n"


def print_module(module: Module) -> str:
    # fallback directives route through the target registry's default
    # profile, so the printer and the selection pass can never disagree
    # about which architecture an undeclared module targets
    default = default_target()
    header = "//\n// Generated by repro PTXASW (shuffle synthesis middle-end)\n//\n"
    header += (f".version {module.version or default.ptx_version}\n"
               f".target {module.target or default.sm_name}\n"
               f".address_size {module.address_size or default.address_size}\n\n")
    return header + "\n".join(print_kernel(k) for k in module.kernels)
