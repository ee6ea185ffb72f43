"""The benchmark's plain references: the served model (`model.py`), the
page pool's invariants (`pages.py`) and the comparisons that decide a
run's `correct` (`compare.py`).  Plain PyTorch and NumPy; nothing here
imports the program."""
