from .arch import (
    ArchModel,
    ArchSequential,
    build_arch_from_lines,
    build_arch_module,
    parse_arch_file,
    parse_arch_lines,
)

__all__ = [
    "ArchModel",
    "ArchSequential",
    "build_arch_from_lines",
    "build_arch_module",
    "parse_arch_file",
    "parse_arch_lines",
]
