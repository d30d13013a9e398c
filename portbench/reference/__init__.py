"""The plain float32 reference: the model (``lm.py``) and one file a
kind of model part (``top.py``, ``attn_global.py``, ``moe.py``,
``ssd.py``, ``none.py``; see ``portbench/kinds.py``), each with its
parameters, forward pass and work counts; they import nothing of the
program."""
