"""Method layer: the labeller base class with its training and transfer
subclasses (counterpart of ``unetsulc_tpu/method/``)."""
