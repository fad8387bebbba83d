"""Published model configurations (copies of ``repro.configs`` modules,
ported one at a time with the slice that first runs them).

``get_config(name, reduced=False)`` returns the published config (full) or
a structure-preserving small one (reduced), equal field for field to the
JAX package's. ``ARCH_IDS`` is the reference's architecture pool; an arch
whose module is not ported yet raises ``NotImplementedError`` naming it.
The SABLE variant ``llama3-8b-sable`` (``llama3_8b.full_sable`` /
``reduced_sable``), which the reference's ``get_config`` does not list, is
served by name here.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "nemotron-4-15b",
    "llama3.2-3b",
    "granite-8b",
    "llama3-8b",
    "mamba2-1.3b",
    "jamba-1.5-large-398b",
    "deepseek-v2-236b",
    "llama4-scout-17b-a16e",
    "chameleon-34b",
    "seamless-m4t-large-v2",
]

# name -> (module, full constructor, reduced constructor)
_MODULES = {
    "nemotron-4-15b": ("nemotron_4_15b", "full", "reduced"),
    "llama3.2-3b": ("llama3_2_3b", "full", "reduced"),
    "granite-8b": ("granite_8b", "full", "reduced"),
    "llama3-8b": ("llama3_8b", "full", "reduced"),
    "llama3-8b-sable": ("llama3_8b", "full_sable", "reduced_sable"),
    "deepseek-v2-236b": ("deepseek_v2_236b", "full", "reduced"),
    "chameleon-34b": ("chameleon_34b", "full", "reduced"),
}


def get_config(name: str, reduced: bool = False):
    if name not in _MODULES:
        if name in ARCH_IDS:
            raise NotImplementedError(
                f"arch {name!r} is not ported yet (ported: {sorted(_MODULES)})"
            )
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS + ['llama3-8b-sable']}")
    module, full, small = _MODULES[name]
    mod = importlib.import_module(f".{module}", __package__)
    return getattr(mod, small if reduced else full)()


from .shapes import SHAPES, shape_applicable  # noqa: E402
