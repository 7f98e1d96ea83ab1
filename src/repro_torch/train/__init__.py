"""Training: AdamW with int8 moments, the train step, checkpoints and
fault tolerance (the port's counterpart of ``repro.train``)."""
