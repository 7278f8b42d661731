"""Version of the PyTorch port (own copy of
``mythril_tpu/__version__.py``: the two packages carry one version, so
a finished report cached by one names the same tool as the other's).

Tracks feature parity with reference mythril/__version__.py:7 (v0.22.7);
our own versioning starts at 0.1.x.
"""

__version__ = "0.1.0"
