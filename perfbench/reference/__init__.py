"""Plain torch solvers of the benchmark's programs, one module a program.

Each module has ``solve(coo, args, source, device, dtype, exact)`` and
``readings(outputs, expected)``.  ``exact=True`` solves to the fixpoint
in the given precision (the yardstick, in float64); ``exact=False``
follows the program's own stopping rule (the control, in a lower
precision).  They take only the benchmark's COO arrays: nothing that
``repro_torch`` made, and nothing of ``repro_torch`` or JAX.
"""
