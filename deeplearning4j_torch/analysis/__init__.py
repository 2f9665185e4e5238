"""graftcheck: AST-based torch-hazard + concurrency static analysis of the
port (its own copy of ``deeplearning4j_tpu/analysis/``).

Run it::

    python -m deeplearning4j_torch.analysis --check

Programmatic entry points live in :mod:`deeplearning4j_torch.analysis.core`
(:func:`~deeplearning4j_torch.analysis.core.run_check`), the rule families
in :mod:`~deeplearning4j_torch.analysis.torch_rules` and
:mod:`~deeplearning4j_torch.analysis.concurrency_rules`, the opt-in
runtime lock-order assertion in
:mod:`~deeplearning4j_torch.analysis.instrument`, and its pytest plugin in
:mod:`~deeplearning4j_torch.analysis.lock_debug`.
"""

from deeplearning4j_torch.analysis.core import (Baseline, Finding, Report,
                                                analyze, run_check)

__all__ = ["Baseline", "Finding", "Report", "analyze", "run_check"]
