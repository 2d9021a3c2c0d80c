"""repro_torch.analysis — the verifier over every shipped benchmark program.

Port of ``repro.analysis``.  The verifier lives in
:mod:`repro_torch.core.verify`; this package is the fleet face: a
registry of every ST program the benchmarks build (:mod:`.programs`) and
a CLI that lints each one and prints a diagnostics table::

    PYTHONPATH=src python -m repro_torch.analysis            # everything
    PYTHONPATH=src python -m repro_torch.analysis faces      # name filter
    PYTHONPATH=src python -m repro_torch.analysis --strict   # CI mode

The exit status is non-zero on error-severity diagnostics; ``--strict``
also fails on warnings and prints the certificate table
(:func:`.programs.certificates`).  ``--device cpu`` builds on the host
(the default is the card); ``--device-count`` sets the ranks (8).
"""

from .programs import certificates, iter_programs, lint_all

__all__ = ["certificates", "iter_programs", "lint_all"]
