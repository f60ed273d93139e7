"""Byte-level BPE tokenizer (GPT-2 scheme) with a UTF-8 byte fallback.

The reference's serving example runs a real HF model with its real
tokenizer (/root/reference/example/vllm-serve/deployment.yaml serves
``mistralai/Mistral-7B-v0.3`` — prompts are tokenized to the model's
vocabulary, completions detokenize to text). This module gives the
llm-serve example the same property for converted GPT-2-family
checkpoints: ``tools/convert_hf.py`` exports the checkpoint's
``vocab.json`` + ``merges.txt`` next to the weights, and serving
round-trips text through the byte-level BPE those files define —
entirely in-repo, no network at serve time.

Three tokenizers:

- :class:`BPETokenizer` — GPT-2's byte-level BPE: text is pre-split by
  the GPT-2 regex, each piece is mapped through the reversible
  byte<->unicode table, then greedily merged by rank. Exactly the
  published algorithm, validated in tests against ``transformers``'
  GPT2Tokenizer loaded from the same files.
- :class:`HFTokenizer` — any ``tokenizer.json`` (the HF fast-tokenizer
  serialization) via the ``tokenizers`` library; what Llama/Mistral
  checkpoints ship (tools/convert_hf.py copies it next to the weights).
- :class:`ByteTokenizer` — ids are UTF-8 bytes. The fallback when no
  tokenizer files exist (randomly initialised demo models): completions
  are still byte-exact round-trips rather than ``chr(id % 128)`` noise.

``load_tokenizer(dir)`` picks whichever the checkpoint directory
supports.
"""

from __future__ import annotations

import functools
import itertools
import json
import os

from k8s_device_plugin_tpu_torch.obs import metrics as obs_metrics

__all__ = ["BPETokenizer", "ByteTokenizer", "HFTokenizer", "load_tokenizer"]

# GPT-2's pre-tokenization pattern: contractions, letter runs, number
# runs, other-symbol runs (each optionally preceded by one space), and
# whitespace (holding back the final run so a trailing space attaches to
# the next word). Needs the `regex` module for \p{L}/\p{N} classes.
_GPT2_SPLIT = (
    r"'s|'t|'re|'ve|'m|'ll|'d|"
    r" ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
)


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> dict[int, str]:
    """The reversible byte -> printable-unicode map byte-level BPE uses.

    Printable ASCII + two latin-1 ranges map to themselves; the 68
    remaining bytes (controls, space, DEL, ...) map to 256, 257, ... so
    every byte gets a visible, non-whitespace character and merges.txt
    stays a plain text file.
    """
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    table = {}
    shift = 0
    for b in range(256):
        if b in printable:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + shift)
            shift += 1
    return table


@functools.lru_cache(maxsize=1)
def unicode_to_bytes() -> dict[str, int]:
    """Inverse of bytes_to_unicode (shared by both BPE-surface
    tokenizers for decoding raw token bytes)."""
    return {c: b for b, c in bytes_to_unicode().items()}


class BPETokenizer:
    """GPT-2 byte-level BPE over a ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]]):
        import regex

        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        # Validate the pair up front: every merge's product must be a
        # vocab entry, or encode() would KeyError at request time on
        # exactly the prompts that trigger the broken merge — a broken
        # conversion should fail at load, not intermittently in serving.
        for a, b in merges:
            if a + b not in self.vocab:
                raise ValueError(
                    f"merge ({a!r}, {b!r}) produces {a + b!r}, which is "
                    "not in vocab.json — broken vocab/merges pair"
                )
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_enc = bytes_to_unicode()
        self.byte_dec = unicode_to_bytes()
        self._split = regex.compile(_GPT2_SPLIT)
        self._word_cache: dict[str, tuple[str, ...]] = {}

    @classmethod
    def load(cls, dir_path: str) -> "BPETokenizer":
        with open(os.path.join(dir_path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges: list[tuple[str, str]] = []
        with open(os.path.join(dir_path, "merges.txt"), encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                # header ("#version: ...") and blank lines are not merges;
                # split() tolerates the trailing/duplicated spaces some
                # exporters leave on merge lines.
                if not line.strip() or line.startswith("#version"):
                    continue
                parts = line.split()
                if len(parts) != 2:
                    raise ValueError(
                        f"merges.txt:{lineno}: expected 'a b', got "
                        f"{line.rstrip()!r}"
                    )
                merges.append((parts[0], parts[1]))
        return cls(vocab, merges)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # Cap on memoised pre-tokens: real text re-uses words heavily, so
    # 64k entries covers it; past the cap the OLDEST half is evicted
    # (dict preserves insertion order) rather than dropping the whole
    # cache — a serving daemon under a trickle of adversarial unique
    # tokens (UUIDs, base64) used to re-pay BPE for its entire hot
    # vocabulary every time the cap tripped, a cold-start cliff on the
    # tokenize hot path. FIFO-half keeps the bound AND most of the hot
    # set; evictions are counted so an operator can see cap pressure.
    _WORD_CACHE_MAX = 65536

    def _bpe(self, word: str) -> tuple[str, ...]:
        """Greedy lowest-rank pair merging of one pre-token."""
        cached = self._word_cache.get(word)
        if cached is not None:
            return cached
        if len(self._word_cache) >= self._WORD_CACHE_MAX:
            drop = self._WORD_CACHE_MAX // 2
            for stale in list(itertools.islice(self._word_cache, drop)):
                del self._word_cache[stale]
            obs_metrics.counter(
                "tpu_serve_tokenizer_cache_evictions_total",
                "BPE word-cache entries evicted at the size cap "
                "(oldest half dropped; the old behaviour cleared "
                "the whole cache)",
            ).inc(drop)
        parts = tuple(word)
        while len(parts) > 1:
            best = min(
                zip(parts, parts[1:]),
                key=lambda p: self.ranks.get(p, float("inf")),
            )
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(parts):
                if (
                    i + 1 < len(parts)
                    and (parts[i], parts[i + 1]) == best
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = tuple(merged)
        self._word_cache[word] = parts
        return parts

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for piece in self._split.findall(text):
            mapped = "".join(
                self.byte_enc[b] for b in piece.encode("utf-8")
            )
            for token in self._bpe(mapped):
                ids.append(self.vocab[token])
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.inv_vocab.get(int(i), "") for i in ids)
        data = bytes(self.byte_dec[c] for c in text if c in self.byte_dec)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        """Raw decoded bytes of one token (for incremental streaming:
        bytes concatenate exactly; text can't, since a character may
        straddle a token boundary)."""
        tok = self.inv_vocab.get(int(token_id), "")
        return bytes(self.byte_dec[c] for c in tok if c in self.byte_dec)


class HFTokenizer:
    """A ``tokenizer.json`` checkpoint tokenizer (Llama/Mistral family).

    Thin adapter over the ``tokenizers`` library exposing the same
    interface as BPETokenizer. ``token_bytes`` reconstructs each token's
    raw bytes from its vocab surface form rather than round-tripping
    through ``decode([id])`` — single-token decodes strip the
    leading-space marker every Metaspace/sentencepiece token carries, so
    streamed concatenation would lose the spaces between words.
    """

    def __init__(self, tok):
        self._tok = tok
        try:
            spec = json.loads(tok.to_str())
        except (ValueError, AttributeError, TypeError):
            # tokenizer backends without to_str(), or non-JSON spec
            # dumps: byte-level detection degrades to the heuristics
            # below, decoding still works.
            spec = {}
        dec = (spec.get("decoder") or {}).get("type", "")
        self._byte_level = dec == "ByteLevel" or any(
            (d or {}).get("type") == "ByteLevel"
            for d in (spec.get("decoder") or {}).get("decoders", []) or []
        )
        self._byte_dec = unicode_to_bytes()

    @classmethod
    def load(cls, dir_path: str) -> "HFTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(
            os.path.join(dir_path, "tokenizer.json")
        ))

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids) -> str:
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=False)

    def token_bytes(self, token_id: int) -> bytes:
        t = self._tok.id_to_token(int(token_id))
        if t is None:
            return b""
        # sentencepiece byte-fallback tokens: "<0x0A>" is the raw byte
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                return bytes([int(t[3:5], 16)])
            except ValueError:
                pass
        if self._byte_level:
            # GPT-2-style surface form: reversible byte<->unicode table
            return bytes(
                self._byte_dec[c] for c in t if c in self._byte_dec
            )
        # Metaspace surface form: the U+2581 marker is a space
        return t.replace("▁", " ").encode("utf-8")


class ByteTokenizer:
    """UTF-8 bytes as token ids — the no-tokenizer-files fallback.

    Any model with vocab_size >= 256 can serve byte-exact round-trip
    text through it (the completion itself is whatever the random or
    toy model emits, but encode/decode is lossless, unlike the old
    ``ord(c) % vocab`` placeholder this replaces).
    """

    vocab_size = 256

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(
            int(i) & 0xFF for i in ids
        ).decode("utf-8", errors="replace")

    def token_bytes(self, token_id: int) -> bytes:
        return bytes([int(token_id) & 0xFF])


def load_tokenizer(checkpoint_dir: str | None):
    """BPETokenizer if the checkpoint dir carries vocab.json+merges.txt,
    HFTokenizer for a tokenizer.json (when the tokenizers lib is
    importable), else ByteTokenizer."""
    if checkpoint_dir:
        vocab = os.path.join(checkpoint_dir, "vocab.json")
        merges = os.path.join(checkpoint_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return BPETokenizer.load(checkpoint_dir)
        if os.path.exists(os.path.join(checkpoint_dir, "tokenizer.json")):
            try:
                return HFTokenizer.load(checkpoint_dir)
            except ImportError:
                pass  # tokenizers lib absent: byte fallback below
    return ByteTokenizer()
