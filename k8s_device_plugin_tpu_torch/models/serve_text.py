"""Host-side text assembly for serving: incremental detokenization,
stop-sequence truncation, and SSE framing.

The reference's serving example fronts vLLM
(/root/reference/example/vllm-serve/deployment.yaml:38), whose
completions API streams tokens and honors ``stop`` strings; this module
gives llm-serve the same semantics. Everything here is pure host logic
(no jax), running at segment boundaries of the continuous engine — the
device scan never sees stop strings, so the compiled path stays static.

Why bytes, not str: byte-level BPE tokens are byte sequences; a
multibyte character (emoji, CJK) can straddle a token boundary, and a
stop string can straddle a *segment* boundary. Operating on the decoded
byte stream makes both exact: stop matching is a byte search, streamed
deltas withhold (a) the longest stop-prefix that could still complete
and (b) any trailing incomplete UTF-8 sequence, so every emitted chunk
is final — no chunk is ever retracted or re-encoded differently later.
"""

from __future__ import annotations

import json

__all__ = ["TextAssembler", "sse_event", "SSE_DONE"]

SSE_DONE = b"data: [DONE]\n\n"


def sse_event(obj) -> bytes:
    """One server-sent event frame carrying a JSON payload."""
    return b"data: " + json.dumps(obj).encode("utf-8") + b"\n\n"


def _utf8_complete_len(buf: bytes) -> int:
    """Length of the longest prefix of ``buf`` not ending mid-character.

    Scans back at most 3 bytes for a multibyte lead still awaiting
    continuation bytes; anything else (including invalid sequences,
    which a byte-fallback model can emit) passes through and decodes
    with errors="replace" — bounded holdback, no stuck bytes.
    """
    n = len(buf)
    for back in range(1, min(3, n) + 1):
        b = buf[n - back]
        if b < 0x80:  # ASCII: complete
            break
        if b >= 0xC0:  # lead byte: expects `need` bytes total
            need = 2 if b < 0xE0 else 3 if b < 0xF0 else 4
            if back < need:
                return n - back
            break
        # else continuation byte: keep scanning back
    return n


class TextAssembler:
    """Accumulates continuation tokens for one request.

    ``push(ids)`` appends tokens, truncating exactly at the earliest
    stop-sequence occurrence (mid-token: the matched token is counted,
    its bytes past the stop are dropped). ``take_delta()`` returns the
    newly-safe text for streaming. ``text()``/``tokens`` give the final
    completion; ``finished`` is True once a stop matched.
    """

    def __init__(self, token_bytes, stop=()):
        self._token_bytes = token_bytes  # callable: id -> bytes
        self.stops = [
            s.encode("utf-8") if isinstance(s, str) else bytes(s)
            for s in stop if s
        ]
        self.buf = bytearray()
        self.tokens: list[int] = []
        self._cum: list[int] = [0]  # byte length after accepting token i
        self._emitted = 0  # bytes already handed out via take_delta
        self.finished = False

    def push(self, token_ids) -> int:
        """Append tokens; returns how many were accepted (the rest fall
        after a completed stop sequence and are discarded)."""
        accepted = 0
        for tid in token_ids:
            if self.finished:
                break
            tid = int(tid)
            prev_len = len(self.buf)
            self.buf += self._token_bytes(tid)
            self.tokens.append(tid)
            self._cum.append(len(self.buf))
            accepted += 1
            hit = self._earliest_stop(prev_len)
            if hit is not None:
                del self.buf[hit:]
                # Keep the minimal token prefix covering the kept bytes:
                # the token the stop landed inside still counts (its
                # leading bytes may be part of the output).
                keep = 0
                while keep < len(self.tokens) and self._cum[keep] < hit:
                    keep += 1
                del self.tokens[keep:]
                del self._cum[keep + 1:]
                self.finished = True
        return accepted

    def _earliest_stop(self, prev_len: int):
        hit = None
        # Every earlier window was already searched when its token was
        # pushed, so only matches ENDING within the newest token's bytes
        # are possible — reach back just far enough for a stop that
        # straddles into them (keeps matching O(tokens), not O(n^2)).
        for s in self.stops:
            i = self.buf.find(s, max(0, prev_len - len(s) + 1))
            if i != -1 and (hit is None or i < hit):
                hit = i
        return hit

    def _unsafe_suffix_len(self) -> int:
        """Longest buffer suffix that is a proper prefix of some stop —
        those bytes may yet become a stop match and cannot stream."""
        best, end = 0, len(self.buf)
        for s in self.stops:
            for k in range(min(len(s) - 1, end), best, -1):
                if self.buf[end - k:] == s[:k]:
                    best = k
                    break
        return best

    def take_delta(self) -> str:
        """Newly emittable text since the last call (may be "")."""
        end = len(self.buf)
        if not self.finished:
            end = max(self._emitted, end - self._unsafe_suffix_len())
            end = _utf8_complete_len(bytes(self.buf[:end]))
        if end <= self._emitted:
            return ""
        delta = bytes(self.buf[self._emitted:end]).decode(
            "utf-8", errors="replace"
        )
        self._emitted = end
        return delta

    def text(self) -> str:
        """The full (stop-truncated) completion text."""
        return bytes(self.buf).decode("utf-8", errors="replace")
