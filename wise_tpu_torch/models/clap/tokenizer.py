"""GPT2 byte-level BPE caption tokenizer for the CLAP text tower.

The reference's CLAP extractor (src/feature/microsoft_clap.py:53-58) embeds
text queries through msclap, whose 2022/2023 checkpoints pair the caption
tower with the GPT2 tokenizer and these conventions (msclap CLAPWrapper):

- every caption gets ``' <|endoftext|>'`` appended, so the sequence always
  ends with the eot token the pooled representation reads;
- the tokenizer pads with ``'!'`` (GPT2 token id 0 — msclap registers it as
  pad_token) to ``text_len`` (= context_length 77) with truncation;
- the pooled position is ``attention_mask.sum() - 1`` — the last REAL
  token, which is what CaptionEncoder's ``lengths`` argument encodes
  (models/clap/model.py CaptionEncoder).

The byte-level BPE engine itself comes from ``transformers.GPT2Tokenizer``
instantiated from LOCAL ``vocab.json`` + ``merges.txt`` (no network);
scripts/fetch_checkpoints.py stages them next to the msclap checkpoint.
Without staged vocab files the extractor falls back to the deterministic
HashTokenizer (random-weight towers only — same caveat as CLIP).

Copy of ``wise_tpu/models/clap/tokenizer.py``, with its imports bound to
wise_tpu_torch. One deliberate deviation (ROADMAP Queue C 2): the BERT
tokenizer's basic split also runs HF ``BasicTokenizer``'s text cleaning
(NUL, U+FFFD and control characters dropped, whitespace made a space) and
its CJK split (each CJK ideograph a word of its own), which the reference's
copy lacks.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def find_gpt2_vocab(
    ckpt_dir: Optional[Path] = None,
) -> Optional[Tuple[Path, Path]]:
    """Locate ``vocab.json`` + ``merges.txt`` in the staging spots: the
    model's checkpoint dir, then the $WISE_CHECKPOINT_DIR/clap root."""
    candidates = []
    if ckpt_dir is not None:
        candidates.append(Path(ckpt_dir))
    root = os.environ.get(
        "WISE_CHECKPOINT_DIR",
        str(Path.home() / ".cache" / "wise_tpu" / "checkpoints"),
    )
    candidates.append(Path(root) / "clap")
    candidates.append(Path(root))
    for d in candidates:
        v, m = d / "vocab.json", d / "merges.txt"
        if v.exists() and m.exists():
            return v, m
    return None


class Gpt2CaptionTokenizer:
    """msclap-convention GPT2 tokenization -> (tokens, lengths) arrays."""

    #: GPT2 token id of '!' — msclap's registered pad token
    PAD_ID = 0

    def __init__(self, vocab_file: Path, merges_file: Path,
                 context_length: int = 77):
        from transformers import GPT2Tokenizer

        self.tok = GPT2Tokenizer(
            vocab_file=str(vocab_file), merges_file=str(merges_file)
        )
        self.tok.add_special_tokens({"pad_token": "!"})
        self.context_length = context_length

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            [t + " <|endoftext|>" for t in texts],
            max_length=self.context_length,
            padding="max_length",
            truncation=True,
        )
        tokens = np.asarray(enc["input_ids"], dtype=np.int32)
        lengths = np.asarray(enc["attention_mask"], dtype=np.int32).sum(
            axis=1
        ).astype(np.int32)
        return tokens, lengths


def find_bert_vocab(ckpt_dir: Optional[Path] = None) -> Optional[Path]:
    """Locate a WordPiece ``vocab.txt`` (msclap-2022's bert-base-uncased
    tokenizer) in the same staging spots as the GPT2 vocab."""
    candidates = []
    if ckpt_dir is not None:
        candidates.append(Path(ckpt_dir))
    root = os.environ.get(
        "WISE_CHECKPOINT_DIR",
        str(Path.home() / ".cache" / "wise_tpu" / "checkpoints"),
    )
    candidates.append(Path(root) / "clap")
    candidates.append(Path(root))
    for d in candidates:
        v = d / "vocab.txt"
        if v.exists():
            return v
    return None


def _is_control(ch: str) -> bool:
    """HF ``_is_control``: category C*, except tab, newline and return."""
    import unicodedata

    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    """HF ``_is_whitespace``: space, tab, newline, return or category Zs."""
    import unicodedata

    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


#: HF ``BasicTokenizer._is_chinese_char``'s CJK ideograph blocks
_CJK_BLOCKS = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_BLOCKS)


class BertCaptionTokenizer:
    """bert-base-uncased WordPiece tokenization -> (tokens, lengths).

    msclap-2022's preprocess_text runs the HF tokenizer with
    ``add_special_tokens=True, max_length=text_len, padding='max_length',
    truncation=True`` and NO eot suffix (that is gpt-only), so each
    caption becomes ``[CLS] pieces [SEP] [PAD]*``. This class implements
    the uncased pipeline natively (lowercase + accent strip + punctuation
    split + greedy longest-match WordPiece) from a staged ``vocab.txt``,
    after HF's text cleaning and CJK split;
    tests/test_torch_clap2022.py pins it piece-for-piece against
    transformers.BertTokenizer on a tiny vocab, CJK and control characters
    included."""

    def __init__(self, vocab_file: Path, context_length: int = 100):
        self.vocab = {}
        with open(vocab_file, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        for tok in ("[PAD]", "[UNK]", "[CLS]", "[SEP]"):
            if tok not in self.vocab:
                raise ValueError(f"vocab.txt missing special token {tok}")
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self.context_length = context_length

    @staticmethod
    def _basic_tokens(text: str) -> List[str]:
        import unicodedata

        # HF BasicTokenizer._clean_text, then _tokenize_chinese_chars
        text = "".join(" " if _is_whitespace(ch) else ch for ch in text
                       if ord(ch) not in (0, 0xFFFD) and not _is_control(ch))
        text = "".join(f" {ch} " if _is_cjk(ch) else ch for ch in text)
        text = text.lower()
        # strip accents (uncased models): NFD then drop combining marks
        text = "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )
        out: List[str] = []
        word = []
        for ch in text:
            cat = unicodedata.category(ch)
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif cat.startswith("P") or ch in "$+<=>^`|~":
                # punctuation splits into its own single-char token
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk_id]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            pieces.append(cur)
            start = end
        return pieces

    def __call__(self, texts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        L = self.context_length
        tokens = np.full((len(texts), L), self.pad_id, np.int32)
        lengths = np.zeros((len(texts),), np.int32)
        for r, t in enumerate(texts):
            ids: List[int] = []
            for w in self._basic_tokens(t):
                ids.extend(self._wordpiece(w))
            ids = [self.cls_id] + ids[: L - 2] + [self.sep_id]
            tokens[r, : len(ids)] = ids
            lengths[r] = len(ids)
        return tokens, lengths


def get_caption_tokenizer(ckpt_dir: Optional[Path], vocab_size: int,
                          context_length: int, kind: str = "gpt2"):
    """Real tokenizer when vocab files are staged AND the tower has the
    matching vocabulary (kind='gpt2': byte-level BPE from vocab.json +
    merges.txt; kind='bert': WordPiece from vocab.txt); deterministic
    hash fallback otherwise (mirrors models/clip/tokenizer.get_tokenizer)."""
    from ..clip.tokenizer import HashTokenizer

    if kind == "bert":
        vb = find_bert_vocab(ckpt_dir)
        if vb is not None:
            try:
                return BertCaptionTokenizer(vb, context_length)
            except Exception as e:
                logger.warning("BERT vocab at %s unusable (%s); hash "
                               "fallback", vb, e)
        else:
            logger.warning(
                "BERT caption vocab (vocab.txt) not staged — using the "
                "deterministic HASH tokenizer fallback. Audio text "
                "queries will NOT match real-checkpoint behaviour; stage "
                "with scripts/fetch_checkpoints.py or WISE_CHECKPOINT_DIR."
            )
        return HashTokenizer(vocab_size=vocab_size,
                             context_length=context_length)

    GPT2_VOCAB = 50257
    found = find_gpt2_vocab(ckpt_dir)
    if found is not None and vocab_size == GPT2_VOCAB:
        try:
            return Gpt2CaptionTokenizer(*found, context_length)
        except Exception as e:  # malformed staging — fall back loudly
            logger.warning("GPT2 vocab at %s unusable (%s); hash fallback",
                           found[0].parent, e)
    elif found is None and vocab_size == GPT2_VOCAB:
        logger.warning(
            "GPT2 caption vocab (vocab.json + merges.txt) not staged — "
            "using the deterministic HASH tokenizer fallback. Audio text "
            "queries will NOT match real-checkpoint behaviour; stage with "
            "scripts/fetch_checkpoints.py or set WISE_CHECKPOINT_DIR."
        )
    return HashTokenizer(vocab_size=vocab_size, context_length=context_length)
