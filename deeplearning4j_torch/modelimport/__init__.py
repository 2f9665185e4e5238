"""Port of the `deeplearning4j_tpu` package of the same path: Keras HDF5
model import (``keras.py``) and the HTTP entry point (``server.py``)."""

from deeplearning4j_torch.modelimport.keras import (
    KerasModelImport,
    import_keras_model_and_weights,
    import_keras_sequential_model_and_weights,
)

__all__ = ["KerasModelImport", "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights"]
