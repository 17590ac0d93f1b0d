# copied from aligntools_tpu/version.py
__version__ = "0.1.0"
