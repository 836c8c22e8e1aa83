"""Plain references of the benchmark's configurations, one file each
(``<config>.py``), on the shared semantics of ``_plain.py``. They import
neither the program under test nor JAX."""
