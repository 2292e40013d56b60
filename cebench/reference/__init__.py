"""The plain reference the program's outputs are judged against: the frozen
float64 estimator (`oracle.py`) and, per deployment kind, what a correct
result is (`pusch.py`, `ce.py`). Numpy only; imports nothing of the program.
"""
