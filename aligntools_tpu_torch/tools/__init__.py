"""Tools of the port: the ceiling probe (``vpu_probe``) and the
differential campaign against the native C++ CLI (``validate``)."""
