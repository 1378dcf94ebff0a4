"""Training (counterpart of ``repro.train``): the optimizers, the train
step and gradient compression."""
