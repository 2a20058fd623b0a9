"""Host-side draft proposers for speculative decoding (counterpart of
:mod:`trlx_tpu.serving.spec_drafter`).

The drafting half of the engine's verify step: a drafter proposes up to
``max_draft`` next tokens per row from host-visible state only (no draft
model, no extra forward), and the verify step accepts the longest prefix
whose tokens equal what the policy samples at those positions
(:func:`trlx_tpu_torch.ops.sampling.accept_drafts`). A wrong draft costs
verify FLOPs, never correctness.

- :class:`NGramDrafter`: prompt-lookup decoding. The longest suffix of a
  row's own history (prompt + committed tokens) that recurred earlier in
  that history predicts its previous continuation. Each row's history
  carries an n-gram index updated as tokens arrive, so a draw reads a few
  dict entries instead of scanning the history.
- :class:`TrieDrafter`: the same, plus a global corpus: the ready chains
  of the shared-prefix trie
  (:meth:`~trlx_tpu_torch.serving.prefix_cache.PrefixBlockPool.ready_chains`),
  so rows draft from what other requests already published. It indexes
  the chains by n-gram once per change of the pool
  (:attr:`~trlx_tpu_torch.serving.prefix_cache.PrefixBlockPool.version`)
  and answers each lookup from the index: the same proposals as scanning
  every chain per draw, at a host cost that does not grow with the pool.

Accept-rate adaptivity: every proposer keeps a per-tenant EWMA of the
verify step's accept fraction (rows map to tenants via :meth:`set_tenant`;
unmapped rows are their own tenant). Below ``min_accept_ewma`` the drafter
returns empty drafts for that tenant and the engine falls through to
one-token decode; every ``DEGRADE_PROBE_EVERY`` suppressed draws it emits
one probe draft so the EWMA can recover.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

__all__ = ["NGramDrafter", "TrieDrafter"]

# One probe draft per this many suppressed draws keeps a degraded
# tenant's EWMA live (pure suppression would freeze it below the bar
# forever).
DEGRADE_PROBE_EVERY = 16


class NGramDrafter:
    """Per-row suffix n-gram self-lookup (prompt-lookup decoding).

    :param max_draft: proposal cap per draw (the engine clamps its own
        ``spec_max_draft`` the same way; the shorter wins).
    :param max_ngram: longest suffix tried as the lookup needle; longer
        matches win (tried first), down to ``min_ngram``.
    :param min_ngram: shortest needle worth matching — 1-gram lookup is
        near-noise on real vocabularies, so the default floor is 2.
    :param min_accept_ewma: accept-rate floor; a tenant whose EWMA sinks
        below it stops drafting (modulo probes). 0 never degrades.
    :param ewma_alpha: EWMA step for each verify outcome.
    """

    def __init__(
        self,
        max_draft: int = 4,
        max_ngram: int = 4,
        min_ngram: int = 2,
        min_accept_ewma: float = 0.0,
        ewma_alpha: float = 0.2,
    ):
        if max_draft < 1:
            raise ValueError(f"max_draft={max_draft} must be >= 1")
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}"
            )
        if not 0.0 <= min_accept_ewma <= 1.0:
            raise ValueError(
                f"min_accept_ewma={min_accept_ewma} must be in [0, 1]"
            )
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(
                f"ewma_alpha={ewma_alpha} must be in (0, 1]"
            )
        self.max_draft = int(max_draft)
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self.min_accept_ewma = float(min_accept_ewma)
        self.ewma_alpha = float(ewma_alpha)
        self._hist: Dict[int, List[int]] = {}
        # per row: {(n, n-gram): (its last start, the start before)}
        self._starts: Dict[int, Dict[tuple, tuple]] = {}
        self._tenant: Dict[int, str] = {}
        # EWMA starts at 1.0: a fresh tenant drafts until evidence says
        # otherwise (starting below the bar would deadlock degrade-off)
        self._ewma: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}
        self.drafts = 0
        self.draft_hits = 0
        self.degraded_draws = 0

    # --------------------------- row lifecycle -------------------------- #

    def observe_context(self, row: int, tokens: Sequence[int]) -> None:
        """Seed a freshly admitted row's history with its (unpadded)
        prompt tokens."""
        self._hist[row], self._starts[row] = [], {}
        self._append(row, tokens)

    def observe_tokens(self, row: int, tokens: Sequence[int]) -> None:
        """Append committed emissions (decode-tap or accepted verify
        columns) to the row's history."""
        self._append(row, tokens)

    def _append(self, row: int, tokens: Sequence[int]) -> None:
        """Extend the row's history and its n-gram index (each n-gram's
        last two start positions), so a lookup costs a few dict reads
        instead of a scan of the history."""
        hist = self._hist.setdefault(row, [])
        starts = self._starts.setdefault(row, {})
        for t in tokens:
            hist.append(int(t))
            L = len(hist)
            for n in range(self.min_ngram, min(self.max_ngram, L) + 1):
                key = (n, tuple(hist[L - n:]))
                last = starts.get(key)
                starts[key] = (L - n, last[0] if last else None)

    def observe_accept(
        self, row: int, n_proposed: int, n_accepted: int
    ) -> None:
        """Fold one verify outcome into the row's tenant EWMA."""
        if n_proposed < 1:
            return
        tenant = self._tenant.get(row, f"row:{row}")
        rate = n_accepted / n_proposed
        prev = self._ewma.get(tenant, 1.0)
        self._ewma[tenant] = (
            self.ewma_alpha * rate + (1.0 - self.ewma_alpha) * prev
        )

    def set_tenant(self, row: int, tenant: Optional[str]) -> None:
        """Map a row to a tenant for accept-rate accounting (rows of
        one tenant share text statistics; unmapped rows degrade
        independently)."""
        if tenant is None:
            self._tenant.pop(row, None)
        else:
            self._tenant[row] = str(tenant)

    def forget(self, row: int) -> None:
        """Drop a harvested row's history (its slot is being reused)."""
        self._hist.pop(row, None)
        self._starts.pop(row, None)
        self._tenant.pop(row, None)

    def reset(self) -> None:
        """Drop all row state (phase boundary). Tenant EWMAs persist —
        accept statistics are a property of the tenant's text, not of
        one phase's slot assignments."""
        self._hist.clear()
        self._starts.clear()
        self._tenant.clear()

    # --------------------------- checkpointing --------------------------- #

    def state_dict(self) -> Dict[str, object]:
        """Resume-carried drafter state: the per-tenant accept EWMAs and
        probe counters decide whether a tenant drafts at all, so a resumed
        run must see the values the killed run had (resetting them to 1.0
        would re-draft for a degraded tenant and diverge from the
        uninterrupted twin). Row histories and tenant maps are
        phase-scoped (``reset()`` drops them at every phase boundary) and
        the counters do not steer drafting, so neither is carried."""
        return {
            "ewma": dict(self._ewma),
            "suppressed": dict(self._suppressed),
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self._ewma = {str(k): float(v) for k, v in state["ewma"].items()}
        self._suppressed = {
            str(k): int(v) for k, v in state["suppressed"].items()
        }

    # ------------------------------ drafting ---------------------------- #

    def accept_ewma(self, tenant: str) -> float:
        return self._ewma.get(tenant, 1.0)

    def _degraded(self, row: int) -> bool:
        """True when this draw should be suppressed for accept-rate
        degrade (counts a probe allowance so the EWMA stays live)."""
        if self.min_accept_ewma <= 0.0:
            return False
        tenant = self._tenant.get(row, f"row:{row}")
        if self._ewma.get(tenant, 1.0) >= self.min_accept_ewma:
            self._suppressed.pop(tenant, None)
            return False
        n = self._suppressed.get(tenant, 0) + 1
        if n >= DEGRADE_PROBE_EVERY:
            self._suppressed[tenant] = 0
            return False  # probe: one draft to refresh the EWMA
        self._suppressed[tenant] = n
        self.degraded_draws += 1
        return True

    def _self_lookup(self, row: int) -> List[int]:
        """Longest-suffix n-gram match of the row's history inside itself:
        the continuation after the most recent earlier occurrence of the
        suffix (the suffix's own, terminal occurrence excluded)."""
        hist, starts = self._hist[row], self._starts[row]
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(hist) < n:
                continue
            prev = starts[(n, tuple(hist[-n:]))][1]
            if prev is not None:
                return hist[prev + n:prev + n + self.max_draft]
        return []

    def draft(self, row: int) -> List[int]:
        """Up to ``max_draft`` proposed next tokens for ``row`` ([] =
        no proposal; the engine falls through to one-token decode)."""
        if self._degraded(row):
            return []
        hist = self._hist.get(row)
        if not hist:
            return []
        self.drafts += 1
        out = self._self_lookup(row)
        if out:
            self.draft_hits += 1
        return out

    def stats(self) -> Dict[str, float]:
        return {
            "spec_drafter/draws": float(self.drafts),
            "spec_drafter/hits": float(self.draft_hits),
            "spec_drafter/degraded_draws": float(self.degraded_draws),
        }


class TrieDrafter(NGramDrafter):
    """N-gram drafting with the shared-prefix trie's ready chains as a
    global corpus, the row's own history first (a row's history is the best
    predictor of its continuation; the trie catches rows whose history has
    not repeated yet but whose prompt family has).

    :param pool: the server's
        :class:`~trlx_tpu_torch.serving.prefix_cache.PrefixBlockPool`;
        ``None`` keeps pure n-gram behavior (sharing off).
    """

    def __init__(self, pool=None, **kwargs):
        super().__init__(**kwargs)
        self.pool = pool
        self.trie_hits = 0
        self._index_version = None
        # per ready chain (in ready_chains order): the chain and
        # {(n, n-gram): the largest start i with a non-empty continuation}
        self._index: List[tuple] = []

    def _chain_index(self) -> List[tuple]:
        if self._index_version != self.pool.version:
            self._index = []
            for chain in self.pool.ready_chains():
                starts = {}
                for n in range(self.min_ngram, self.max_ngram + 1):
                    for i in range(len(chain) - n):  # i + n < len(chain)
                        starts[(n, tuple(chain[i:i + n]))] = i
                self._index.append((chain, starts))
            self._index_version = self.pool.version
        return self._index

    def _chain_lookup(self, hist: Sequence[int], chain, starts) -> List[int]:
        """Longest-suffix n-gram match of ``hist`` in one indexed chain:
        the continuation after the chain's last occurrence of the suffix
        that has one."""
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(hist) < n:
                continue
            i = starts.get((n, tuple(hist[-n:])))
            if i is not None:
                return list(chain[i + n:i + n + self.max_draft])
        return []

    def draft(self, row: int) -> List[int]:
        if self._degraded(row):
            return []
        hist = self._hist.get(row)
        if not hist:
            return []
        self.drafts += 1
        out = self._self_lookup(row)
        if out:
            self.draft_hits += 1
            return out
        if self.pool is not None:
            # chains extend their parents, so several can match with
            # continuations of different depth: the longest proposal wins
            # (the first of equal length)
            best: List[int] = []
            for chain, starts in self._chain_index():
                cand = self._chain_lookup(hist, chain, starts)
                if len(cand) > len(best):
                    best = cand
            if best:
                self.draft_hits += 1
                self.trie_hits += 1
                return best
        return []

    def stats(self) -> Dict[str, float]:
        out = super().stats()
        out["spec_drafter/trie_hits"] = float(self.trie_hits)
        return out
