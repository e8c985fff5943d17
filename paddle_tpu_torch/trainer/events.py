"""Training events (reference: python/paddle/v2/event.py)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BeginPass:
    pass_id: int


@dataclass
class EndPass:
    pass_id: int
    evaluator_results: dict = field(default_factory=dict)


@dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


@dataclass
class EndIteration:
    pass_id: int
    batch_id: int
    cost: float
    evaluator_results: dict = field(default_factory=dict)


@dataclass
class TestResult:
    pass_id: int
    cost: float
    evaluator_results: dict = field(default_factory=dict)
