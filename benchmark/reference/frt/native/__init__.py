"""The host C++ walks of the port's native/ are not in this copy:
`available()` is False, so the scene compiler takes its Python OBJ scan
and divide walk (scene/obj_loader._scan_obj_python,
scene/divide.shadow_ranks_python), which the port's C++ is held to bit
for bit. PNG textures cannot be read here (the benchmark's scenes have
none)."""

from __future__ import annotations


def available() -> bool:
    return False


def parse_obj(path: str):
    raise RuntimeError("the reference copy has no host C++ OBJ scan")


def shadow_ranks(root, threshold: int, n_leaves: int):
    raise RuntimeError("the reference copy has no host C++ divide walk")


def png_unfilter(raw: bytes, h: int, stride: int, bpp: int):
    raise RuntimeError("the reference copy reads no PNG files")
