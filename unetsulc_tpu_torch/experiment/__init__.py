"""Experiment layer: the K-fold CV driver, the tensorboard event writer and
the evaluation CSVs (counterpart of ``unetsulc_tpu/experiment/``)."""
