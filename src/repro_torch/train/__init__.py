"""Training, the twin of ``repro/train``: data, AdamW, train steps and
checkpoints (``data``, ``optimizer``, ``steps``, ``checkpoint``)."""
