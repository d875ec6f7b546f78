"""CLIP byte-pair-encoding tokenizer.

A from-scratch implementation of the BPE scheme used by CLIP/open_clip:
lowercase + whitespace-normalise, split on words, encode bytes through the
bytes<->unicode table, merge by learned BPE ranks, append '</w>' to word
ends, wrap with SOT/EOT, pad/truncate to context_length.

The merge table (``bpe_simple_vocab_16e6.txt.gz``) ships with open_clip
checkpoints; pass its path (or place it next to the checkpoint). When no
vocab file is available (hermetic tests, random-weight benches) a
deterministic hashing tokenizer stands in — same interface, stable ids.

Copy of ``wise_tpu/models/clip/tokenizer.py``, with its imports bound to wise_tpu_torch.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import logging
import re
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's exact word-split pattern (open_clip SimpleTokenizer). The `regex`
# module provides \p{L}/\p{N}; the stdlib fallback approximates them
# ([^\W\d_]+ ~ letters, [0-9] ~ digits, [^\s\w]+ ~ punctuation — the
# fallback treats '_' and non-ASCII digits slightly differently).
try:
    import regex as _regex

    _WORD_PAT = _regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _regex.IGNORECASE,
    )
except ImportError:  # pragma: no cover - regex ships with transformers
    _WORD_PAT = re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|[0-9]|[^\s\w]+""",
        re.IGNORECASE | re.UNICODE,
    )


class BPETokenizer:
    def __init__(self, bpe_path, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if str(bpe_path).endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.vocab_size = len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(
                pairs, key=lambda p: self.bpe_ranks.get(p, float("inf"))
            )
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                if (
                    i < len(word) - 1
                    and word[i] == first
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for word in _WORD_PAT.findall(text):
            word_b = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(word_b).split(" "))
        return tokens

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > self.context_length:
                toks = toks[: self.context_length]
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


class HashTokenizer:
    """Deterministic stand-in when no BPE/sentencepiece vocab file is
    available: each whitespace word hashes to a stable id in
    [1000, vocab-1000). Same text -> same ids; EOT is the max id so argmax
    pooling still finds it; pad_id configures the padding convention (0 for
    CLIP, 1 for RoBERTa-style towers)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 pad_id: int = 0):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.pad_id = pad_id
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        out = []
        for w in words:
            if not w:
                continue
            h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "big")
            out.append(1000 + h % (self.vocab_size - 3000))
        return out

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.full(
            (len(texts), self.context_length), self.pad_id, dtype=np.int32
        )
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > self.context_length:
                toks = toks[: self.context_length]
                toks[-1] = self.eot
            out[i, : len(toks)] = toks
        return out


def find_bpe_vocab() -> Optional[Path]:
    """Locate ``bpe_simple_vocab_16e6.txt.gz`` in the shared staging spots:
    $WISE_CHECKPOINT_DIR root (scripts/fetch_checkpoints.py drops a copy per
    model dir, but a root-level copy serves every model) or the packaged
    data dir."""
    import os

    name = "bpe_simple_vocab_16e6.txt.gz"
    candidates = []
    ckpt = os.environ.get("WISE_CHECKPOINT_DIR")
    if ckpt:
        candidates.append(Path(ckpt) / name)
    candidates.append(
        Path.home() / ".cache" / "wise_tpu" / "checkpoints" / name
    )
    candidates.append(Path(__file__).parent / "data" / name)
    for c in candidates:
        if c.exists():
            return c
    return None


#: token count the classic CLIP BPE merge table produces; the auto-found
#: staged vocab must only serve towers with exactly this vocabulary —
#: feeding 49408-token ids into a smaller embedding table (SigLIP's 32000
#: sentencepiece vocab, tiny test configs) would silently clamp indices
CLIP_BPE_VOCAB_SIZE = 49408


def get_tokenizer(
    bpe_path: Optional[Path] = None,
    vocab_size: int = CLIP_BPE_VOCAB_SIZE,
    context_length: int = 77,
):
    explicit = bpe_path is not None and Path(bpe_path).exists()
    if not explicit:
        bpe_path = (
            find_bpe_vocab() if vocab_size == CLIP_BPE_VOCAB_SIZE else None
        )
    if bpe_path is not None and Path(bpe_path).exists():
        return BPETokenizer(bpe_path, context_length)
    if vocab_size == CLIP_BPE_VOCAB_SIZE:
        logger.warning(
            "CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz) not found — "
            "using the deterministic HASH tokenizer fallback. Retrieval "
            "text queries will NOT match real-checkpoint behaviour; stage "
            "the vocab with scripts/fetch_checkpoints.py or set "
            "WISE_CHECKPOINT_DIR."
        )
    else:
        logger.warning(
            "no tokenizer for a %d-token vocabulary (the staged CLIP BPE "
            "table only serves %d-token towers) — using the deterministic "
            "HASH tokenizer fallback; stage the model's own tokenizer "
            "assets for real-checkpoint behaviour.",
            vocab_size, CLIP_BPE_VOCAB_SIZE,
        )
    return HashTokenizer(vocab_size, context_length)
