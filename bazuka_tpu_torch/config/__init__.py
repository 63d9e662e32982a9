"""Chain configuration presets (reference: src/config/).
A copy of `bazuka_tpu/config/__init__.py`."""

from . import blockchain  # noqa: F401
