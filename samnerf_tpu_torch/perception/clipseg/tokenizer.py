"""CLIP's byte-pair-encoding tokenizer, counterpart of
``samnerf_tpu/perception/clipseg/tokenizer.py``.

The merges file (``bpe_simple_vocab_16e6.txt.gz`` in CLIP's releases, or
any gzip file in its format) is given at run time; nothing is downloaded.
The JAX package splits text with the ``regex`` module's pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
[^\\s\\p{L}\\p{N}]+`` (case-insensitive).  This module makes the same
split with the standard library: the two markers and the contractions
through ``re`` (case-insensitive, as there), letters and numbers by their
``unicodedata`` category (``L*``, ``N*``), and a run of anything else that
is not white space.  Under case-insensitive matching ``regex`` leaves out
of that last run a character one of whose case variants is a letter or a
number (U+0345), and so does :func:`_is_other`.  Code points that are
unassigned in Python's Unicode tables but assigned in ``regex``'s newer
ones may split differently.  ``ftfy`` is used when it is installed, as
there.
"""
from __future__ import annotations

import gzip
import html
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
_MARKERS = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d",
                      re.IGNORECASE)


@lru_cache()
def bytes_to_unicode():
    """Each byte -> a printable character, the printable bytes mapping to
    themselves."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return set(zip(word[:-1], word[1:]))


def basic_clean(text):
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """In ``[^\\s\\p{L}\\p{N}]`` under ``regex``'s case-insensitive match:
    not white space, and no case variant a letter or a number."""
    return not c.isspace() and not any(
        len(v) == 1 and unicodedata.category(v)[0] in "LN"
        for v in (c, c.upper(), c.lower(), c.casefold()))


def pre_tokenize(text: str) -> List[str]:
    """The pieces the pattern's ``findall`` gives, left to right: at each
    position the first alternative that matches, else the character is
    skipped."""
    pieces, i, n = [], 0, len(text)
    while i < n:
        m = _MARKERS.match(text, i)
        if m:
            pieces.append(m.group())
            i = m.end()
            continue
        c = text[i]
        if _is_number(c):
            pieces.append(c)
            i += 1
            continue
        run = _is_letter if _is_letter(c) else _is_other if _is_other(c) else None
        if run is None:
            i += 1
            continue
        j = i + 1
        while j < n and run(text[j]):
            j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


class SimpleTokenizer:
    def __init__(self, bpe_path: Union[str, Path]):
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1]]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        word = " ".join(word)
        self.cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        tokens = []
        for piece in pre_tokenize(whitespace_clean(basic_clean(text)).lower()):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(piece).split(" "))
        return tokens


def tokenize(tokenizer: SimpleTokenizer, texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """-> [B, context_length] int32: start-of-text, the tokens, end-of-text
    (the last kept token replaced by end-of-text when the text is too
    long), zeros after."""
    if isinstance(texts, str):
        texts = [texts]
    sot = tokenizer.encoder["<|startoftext|>"]
    eot = tokenizer.encoder["<|endoftext|>"]
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [sot] + tokenizer.encode(text) + [eot]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = eot
        out[i, :len(tokens)] = tokens
    return out
