"""Repeated-pattern mining over symbol sequences via a suffix automaton
(the JAX package's ``sofa_tpu/ml/suffix.py``, unchanged but for the
imports).

Every automaton state stands for an endpos-equivalence class of
substrings; its occurrence count is the size of that class's endpos set
(propagated up the suffix links), and its longest substring is
``len(state)``.  Finding "the longest substring occurring about N times"
is then a linear scan over the states.  The symbols are any hashables:
here, kernel names interned to ids.
"""

from __future__ import annotations

from typing import Hashable, List, Optional, Sequence, Tuple


class SuffixAutomaton:
    """Online suffix automaton over a sequence of hashable symbols."""

    def __init__(self, seq: Sequence[Hashable]):
        # state arrays: link, length, transitions, clone flag
        self.link: List[int] = [-1]
        self.length: List[int] = [0]
        self.next: List[dict] = [{}]
        self.is_clone: List[bool] = [False]
        self.first_end: List[int] = [0]   # end position of first occurrence
        self.last = 0
        for i, sym in enumerate(seq):
            self._extend(sym, i)
        self._counts: Optional[List[int]] = None
        self.n = len(seq)

    def _new_state(self, link, length, nxt, clone, first_end) -> int:
        self.link.append(link)
        self.length.append(length)
        self.next.append(nxt)
        self.is_clone.append(clone)
        self.first_end.append(first_end)
        return len(self.link) - 1

    def _extend(self, sym, pos: int) -> None:
        cur = self._new_state(-1, self.length[self.last] + 1, {}, False, pos)
        p = self.last
        while p != -1 and sym not in self.next[p]:
            self.next[p][sym] = cur
            p = self.link[p]
        if p == -1:
            self.link[cur] = 0
        else:
            q = self.next[p][sym]
            if self.length[p] + 1 == self.length[q]:
                self.link[cur] = q
            else:
                clone = self._new_state(
                    self.link[q], self.length[p] + 1, dict(self.next[q]),
                    True, self.first_end[q],
                )
                while p != -1 and self.next[p].get(sym) == q:
                    self.next[p][sym] = clone
                    p = self.link[p]
                self.link[q] = clone
                self.link[cur] = clone
        self.last = cur

    def occurrence_counts(self) -> List[int]:
        """cnt[state] = number of occurrences of the substrings in state."""
        if self._counts is not None:
            return self._counts
        n_states = len(self.link)
        cnt = [0] * n_states
        for s in range(n_states):
            if s != 0 and not self.is_clone[s]:
                cnt[s] = 1
        order = sorted(range(1, n_states), key=lambda s: self.length[s], reverse=True)
        for s in order:
            parent = self.link[s]
            if parent >= 0:
                cnt[parent] += cnt[s]
        self._counts = cnt
        return cnt

    def repeat_candidates(
        self,
        target: int,
        tolerance: int = 0,
        min_len: int = 1,
        max_candidates: int = 32,
        prefer_len: Optional[float] = None,
    ) -> List[Tuple[int, int, int]]:
        """Substrings whose (overlapping) occurrence count is target±tolerance.

        Returns up to max_candidates (start, length, count) tuples of first
        occurrences — nearest ``prefer_len`` first when given (callers that
        know the expected period, e.g. len(seq)/target, MUST pass it: on a
        long k-period sequence the in-tolerance candidates number in the
        thousands and are dominated by multi-period patterns, so a plain
        longest-first truncation would drop every single-period candidate),
        longest first otherwise.  Overlapping counts over-report periodic
        patterns (a 2-period pattern in a k-period sequence occurs k-1
        times, not k/2), so callers must re-verify candidates with a
        non-overlapping scan (find_occurrences) before trusting the count.
        """
        cnt = self.occurrence_counts()
        out = []
        for s in range(1, len(self.link)):
            c = cnt[s]
            if abs(c - target) <= tolerance and self.length[s] >= min_len:
                out.append((self.first_end[s] - self.length[s] + 1, self.length[s], c))
        if prefer_len is not None:
            out.sort(key=lambda t: (abs(t[1] - prefer_len), -t[1]))
        else:
            out.sort(key=lambda t: -t[1])
        return out[:max_candidates]

    def best_repeat(
        self,
        target: int,
        tolerance: int = 0,
        min_len: int = 1,
    ) -> Optional[Tuple[int, int, int]]:
        """Longest substring occurring target±tolerance times (overlapping
        count) — see repeat_candidates for the caveat."""
        cands = self.repeat_candidates(target, tolerance, min_len, max_candidates=1)
        return cands[0] if cands else None


def find_occurrences(seq: Sequence[Hashable], pattern: Sequence[Hashable]) -> List[int]:
    """Non-overlapping left-to-right occurrences of pattern in seq."""
    out = []
    m = len(pattern)
    if m == 0:
        return out
    pat = list(pattern)
    i = 0
    n = len(seq)
    while i + m <= n:
        if list(seq[i:i + m]) == pat:
            out.append(i)
            i += m
        else:
            i += 1
    return out


def fuzzy_occurrences(
    seq: Sequence[Hashable],
    pattern: Sequence[Hashable],
    min_ratio: float = 0.9,
    max_full_checks: int = 20_000,
) -> List[int]:
    """Non-overlapping matches allowing small edits (a difflib ratio of at
    least ``min_ratio``).

    A naive scan runs difflib at every position — O(n·m²) on the degraded
    captures (no steps, no markers) where this fallback triggers, which can
    be ~10^5 events.  Positions are instead pre-screened
    with an incrementally-maintained multiset bound: difflib's ratio() can
    never exceed quick_ratio() = 2·Σmin(counts)/(|window|+|pattern|), and
    that bound updates in O(1) as the window slides, so the full matcher
    only runs where a match is arithmetically possible.  A hard cap on full
    checks bounds adversarial inputs; hitting it warns and returns the
    matches found so far.
    """
    import difflib
    from collections import Counter

    out: List[int] = []
    m = len(pattern)
    if m == 0:
        return out
    pat = list(pattern)
    n = len(seq)
    pcount = Counter(pat)

    i = 0
    full_checks = 0
    wc: Optional[Counter] = None     # counts for the window at i
    common = 0                       # Σ min(wc[x], pcount[x]) for that window
    # the i < n guard matters for m == 1, where i + m//2 <= n admits i == n
    # (an empty window that can never match but whose slide would read
    # seq[n])
    while i + m // 2 <= n and i < n:
        j = min(i + m, n)
        if wc is None:  # (re)build after init or a post-match jump
            wc = Counter(seq[i:j])
            common = sum(min(c, pcount[x]) for x, c in wc.items())
        wlen = j - i
        if 2.0 * common / (wlen + m) >= min_ratio:  # quick_ratio bound
            full_checks += 1
            if full_checks > max_full_checks:
                from sofa_tpu_torch.printing import print_warning

                print_warning(
                    f"fuzzy iteration scan capped after {max_full_checks} "
                    f"window checks ({len(out)} matches kept; sequence of "
                    f"{n} events is too noisy for the fuzzy fallback)")
                return out
            window = list(seq[i:j])
            if difflib.SequenceMatcher(None, window, pat).ratio() >= min_ratio:
                out.append(i)
                i += max(wlen, 1)
                wc = None  # window jumped; rebuild lazily
                continue
        # slide one position: drop seq[i], admit seq[i+m] if it exists
        x = seq[i]
        if wc[x] <= pcount[x]:
            common -= 1
        wc[x] -= 1
        if i + m < n:
            y = seq[i + m]
            wc[y] += 1
            if wc[y] <= pcount[y]:
                common += 1
        i += 1
    return out
