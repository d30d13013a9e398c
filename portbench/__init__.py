"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric is a file
of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``,
``metrics/<metric>.py``, ``limits/<cell>.json``; so is each model part
(``reference/<kind>.py``, ``kinds.py``) and each traffic kind's loop
(``loops/<kind>.py``). The yardstick (traffic
generator, trace reduction, peaks and work counts, the plain reference
and the comparison that decides ``correct``) lives here too, so the
program under test cannot move it.
"""
