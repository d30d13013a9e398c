"""The loops that drive the engine through a window, one file a traffic
kind (``<kind>.py``, named by a mix's ``kind``); see ``harness.py``."""
