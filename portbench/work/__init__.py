"""Frozen copies of the peaks and of each kernel's operation and byte
counts (``<kernel>.py``), and the model's own counts (``model.py``)."""
