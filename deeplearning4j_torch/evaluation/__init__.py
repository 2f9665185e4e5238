"""Port of the `deeplearning4j_tpu` package of the same path."""
