"""Port of the `deeplearning4j_tpu` package of the same path: the HTTP
entry point (``server.py``). The Keras HDF5 import (``keras.py``) is not
ported yet (ROADMAP A12)."""
