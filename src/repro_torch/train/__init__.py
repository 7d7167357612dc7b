"""The LM trainer (port of repro.train): the train step, checkpoints and
fault tolerance."""
