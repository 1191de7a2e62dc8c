"""Training events — the port's own copy of the framework-free
``paddle_tpu/trainer/events.py`` (python/paddle/v2/event.py analog).

The v2 trainer invokes a user ``event_handler`` with BeginPass/EndPass/
BeginIteration/EndIteration events carrying cost and evaluator results
(reference: python/paddle/v2/trainer.py:108-173, event.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["BeginPass", "EndPass", "BeginIteration", "EndIteration",
           "TestResult", "Resize"]


@dataclass
class BeginPass:
    pass_id: int


@dataclass
class EndPass:
    pass_id: int
    evaluator: Dict[str, float] = field(default_factory=dict)


@dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    cost: float
    evaluator: Dict[str, float] = field(default_factory=dict)


@dataclass
class TestResult:
    pass_id: int
    cost: float
    evaluator: Dict[str, float] = field(default_factory=dict)


@dataclass
class Resize:
    """Elastic gang resize in progress at a batch boundary: the rank is
    about to drain, commit, and re-enter the published world (docs/
    resilience.md "Elastic gang").  Fired BEFORE the commit so handlers
    (and the chaos harness's ``die_during_resize``) observe the protocol
    window; ``grew`` distinguishes grow-back from shrink."""

    pass_id: int
    batch_id: int
    epoch: int
    world_size: int
    grew: bool
