"""Radiation-field package.

Re-exports the reference-shaped surface lazily (RadiationField and
Opacities live in ``stardis_tpu_torch.base``, which imports submodules of
this package: an eager re-export would be circular).
"""

__all__ = ["Opacities", "RadiationField", "create_stellar_radiation_field"]


def __getattr__(name):
    if name in __all__:
        from . import base

        return getattr(base, name)
    raise AttributeError(name)
