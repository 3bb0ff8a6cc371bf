"""CLIP BPE tokenizer (pure Python) for query-bank init and zero-shot paths.

The reference reaches tokenization through HF's Rust tokenizers
(src/models.py:153,162). Tokenization here is init-time only
(never in the train/infer hot path), so a pure-Python BPE is plenty; it loads
the standard CLIP vocab.json + merges.txt when available. This zero-egress
image has no vocab files, so a deterministic `HashTokenizer` fallback with
the same interface keeps every downstream path runnable; swap in real vocab
files for real checkpoints.

Padding uses id 0 (OWL-ViT pads with "!" = id 0) so the detector's
`query_mask = input_ids[..., 0] > 0` convention holds (HF
modeling_owlvit.py:1624-1626).

The port's copy of owlvit_tpu/data/tokenizer.py (the port imports
nothing of the JAX package); tests/test_torch_text.py holds it equal.
"""

from __future__ import annotations

import functools
import json
from typing import Sequence

import numpy as np

try:
    import regex as _re
except ImportError:  # pragma: no cover
    _re = None

_PATTERN = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)


@functools.lru_cache()
def _bytes_to_unicode() -> dict:
    """GPT-2/CLIP reversible byte -> unicode-char table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _whitespace_clean(text: str) -> str:
    import re

    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, vocab_file: str, merges_file: str, max_len: int = 16):
        if _re is None:
            raise ImportError("CLIPTokenizer requires the `regex` module")
        with open(vocab_file) as f:
            self.vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip the version header if present
        if lines and lines[0].startswith("#"):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_len = max_len
        self.sot = self.vocab["<|startoftext|>"]
        self.eot = self.vocab["<|endoftext|>"]
        self.pat = _re.compile(_PATTERN, _re.IGNORECASE)
        self._cache: dict = {}

    def _bpe(self, token: str) -> list:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and (word[i], word[i + 1]) == best
                ):
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list:
        text = _whitespace_clean(text).lower()
        ids = [self.sot]
        for tok in self.pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.vocab[t] for t in self._bpe(tok))
        ids.append(self.eot)
        return ids

    def __call__(self, texts: Sequence[str]) -> dict:
        return _batch_encode(self.encode, texts, self.max_len, self.eot)


class HashTokenizer:
    """Deterministic stand-in when no CLIP vocab files exist: one id per
    lowercased word via a stable hash. EOT is the highest id so the text
    encoder's argmax pooling works identically."""

    def __init__(self, vocab_size: int = 49408, max_len: int = 16):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def _word_id(self, w: str) -> int:
        import hashlib

        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 1 + h % (self.vocab_size - 3)

    def encode(self, text: str) -> list:
        words = _whitespace_clean(text).lower().split(" ")
        return [self.sot] + [self._word_id(w) for w in words] + [self.eot]

    def __call__(self, texts: Sequence[str]) -> dict:
        return _batch_encode(self.encode, texts, self.max_len, self.eot)


def _batch_encode(encode, texts, max_len: int, eot: int) -> dict:
    """Shared pad/truncate/EOT batching for both tokenizers — ONE place for
    the truncation rule (EOT stays last) and the attention-mask semantics,
    so the HashTokenizer fallback can never drift from the real BPE path."""
    N = len(texts)
    input_ids = np.zeros((N, max_len), np.int32)
    attn = np.zeros((N, max_len), np.int32)
    for i, t in enumerate(texts):
        ids = encode(t)[:max_len]
        ids[-1] = eot  # keep EOT last under truncation
        input_ids[i, : len(ids)] = ids
        attn[i, : len(ids)] = 1
    return {"input_ids": input_ids, "attention_mask": attn}


def prompt_templates(label: str) -> list:
    """The reference's 3 prompts per class (models.py:156-159)."""
    return [label, "a photo of " + label, "a " + label + " in an environment"]


def build_prompts(labelmap: dict) -> list:
    """labelmap {idx: name} -> 3*C prompt strings in class order."""
    out = []
    for idx in sorted(labelmap):
        out.extend(prompt_templates(labelmap[idx]))
    return out
