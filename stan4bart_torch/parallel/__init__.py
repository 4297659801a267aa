"""Convergence diagnostics, and chains and observations over several
processes (``multihost``, ``mesh``)."""
