"""Sampler chain (counterpart of the JAX package's runtime/sampling.py).

Composable host-side samplers over a candidate array (reference
src/llama-sampling.cpp), cut down to the default chain: top-k → top-p →
min-p → temp → dist, or greedy. A chain that is
stateless is also described by `device_spec`, so LlamaContext samples on
the device and only the token id comes back. The other samplers (typical,
XTC, mirostat, DRY, penalties, grammar, …) are queued in ROADMAP.md.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Protocol

import numpy as np


@dataclass
class Candidates:
    ids: np.ndarray  # int32 [n]
    logits: np.ndarray  # float32 [n]
    probs: np.ndarray | None = None
    sorted: bool = False

    @classmethod
    def from_logits(cls, logits: np.ndarray) -> "Candidates":
        logits = np.asarray(logits, dtype=np.float32).reshape(-1)
        return cls(np.arange(len(logits), dtype=np.int32), logits.copy())

    def softmax(self) -> None:
        """llama_sampler_softmax_impl: sort desc + normalized probs."""
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True
        p = np.exp(self.logits - self.logits[0])
        self.probs = p / p.sum()

    def truncate(self, k: int) -> None:
        self.ids = self.ids[:k]
        self.logits = self.logits[:k]
        if self.probs is not None:
            self.probs = self.probs[:k]


class Sampler(Protocol):
    """Filters `cand` in place, or returns the chosen token id."""

    def apply(self, cand: Candidates, rng: np.random.Generator) -> int | None: ...


@dataclass
class Greedy:
    def apply(self, cand, rng):
        return int(cand.ids[int(np.argmax(cand.logits))])


@dataclass
class Dist:
    """Final sampler: draw from the softmax distribution."""

    def apply(self, cand, rng):
        cand.softmax()
        return int(cand.ids[rng.choice(len(cand.probs), p=cand.probs)])


@dataclass
class TopK:
    k: int

    def apply(self, cand, rng):
        if self.k <= 0:
            return None
        k = min(self.k, len(cand.ids))
        if not cand.sorted:
            part = np.argpartition(-cand.logits, k - 1)[:k]
            order = part[np.argsort(-cand.logits[part], kind="stable")]
            cand.ids = cand.ids[order]
            cand.logits = cand.logits[order]
            cand.probs = None
            cand.sorted = True
        cand.truncate(k)
        return None


@dataclass
class TopP:
    p: float
    min_keep: int = 1

    def apply(self, cand, rng):
        if self.p >= 1.0:
            return None
        cand.softmax()
        cut = int(np.searchsorted(np.cumsum(cand.probs), self.p)) + 1
        cand.truncate(max(cut, self.min_keep))
        return None


@dataclass
class MinP:
    p: float
    min_keep: int = 1

    def apply(self, cand, rng):
        if self.p <= 0.0:
            return None
        keep = cand.logits >= cand.logits.max() + np.log(self.p)
        if keep.sum() >= self.min_keep:
            cand.ids = cand.ids[keep]
            cand.logits = cand.logits[keep]
            cand.probs = None
            cand.sorted = False
        return None


@dataclass
class Temp:
    t: float

    def apply(self, cand, rng):
        if self.t <= 0:
            best = int(np.argmax(cand.logits))
            cand.ids = cand.ids[best:best + 1]
            cand.logits = cand.logits[best:best + 1]
            cand.probs = None
            return None
        cand.logits = cand.logits / self.t
        cand.probs = None
        return None


@dataclass
class SamplerChain:
    samplers: list = field(default_factory=list)
    rng: np.random.Generator = field(default_factory=lambda: np.random.default_rng(0))

    @property
    def device_spec(self) -> dict | None:
        """Parameters for on-device sampling (ops/device_sampling) when the
        chain is greedy or the stateless top-k → top-p → min-p → temp → dist
        pipeline; None otherwise (host path)."""
        from ..ops.device_sampling import MAX_DEVICE_TOP_K

        if len(self.samplers) == 1 and isinstance(self.samplers[0], Greedy):
            # greedy is top_k=1 on device: argmax, same first-max tie-break
            return {"top_k": 1, "top_p": 1.0, "min_p": 0.0, "temp": 1.0}
        spec = {"top_k": 0, "top_p": 1.0, "min_p": 0.0, "temp": 1.0}
        seen_dist = False
        for s in self.samplers:
            if isinstance(s, TopK):
                spec["top_k"] = s.k
            elif isinstance(s, TopP):
                spec["top_p"] = float(s.p)
            elif isinstance(s, MinP):
                spec["min_p"] = float(s.p)
            elif isinstance(s, Temp) and s.t > 0:
                spec["temp"] = float(s.t)
            elif isinstance(s, Dist):
                seen_dist = True
            else:
                return None
        if not seen_dist or not 0 < spec["top_k"] <= MAX_DEVICE_TOP_K:
            return None
        return spec

    def sample(self, logits: np.ndarray) -> int:
        cand = Candidates.from_logits(logits)
        token: int | None = None
        for s in self.samplers:
            token = s.apply(cand, self.rng)
            if token is not None:
                break
        if token is None:  # no terminal sampler fired: greedy over what's left
            token = int(cand.ids[int(np.argmax(cand.logits))])
        return token


def make_chain(*, seed: int = 0, temp: float = 0.8, top_k: int = 40, top_p: float = 0.95,
               min_p: float = 0.05) -> SamplerChain:
    """Default chain ordering (common_sampler_init, common/sampling.cpp):
    top-k → top-p → min-p → temp → dist; temp <= 0 is greedy. (The
    reference's penalties sampler, first in the chain, changes nothing at its
    defaults and is queued with the other samplers.)"""
    if temp <= 0:
        return SamplerChain([Greedy()], np.random.default_rng(seed))
    return SamplerChain([TopK(top_k), TopP(top_p), MinP(min_p), Temp(temp), Dist()],
                        np.random.default_rng(seed))
