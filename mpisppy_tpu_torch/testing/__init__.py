"""Test-only machinery (fault injection, harness helpers).

Nothing in the production wheel imports this package on a clean run —
the fault-injection hooks in ``utils/multiproc._spoke_worker`` gate the
import behind an explicit fault plan (spoke option or
``MPISPPY_TPU_FAULT_PLAN``), so the disabled path pays zero imports and
zero per-call overhead. ``tests/test_torch_faults.py`` asserts this with a
clean-interpreter import check.
"""
