"""CLIP text tokenization (byte-pair encoding): the PyTorch package's own copy
of vidseg_diffusion_tpu/io/tokenizer.py (:43-232; numpy only, the two
packages share no module).

open_clip.tokenize semantics: lowercased, whitespace-cleaned text split by
CLIP's pattern, mapped through the byte -> unicode table, merged by BPE rank
with `</w>` end-of-word markers, framed as [SOT, ids..., EOT] and
zero-padded to 77 (an over-long prompt is cut and EOT forced into the last
slot). The 49,408-entry production vocabulary (open_clip's
bpe_simple_vocab_16e6.txt.gz) is not in the repository: pass its path as
`bpe_path` or set $VIDSEG_BPE_PATH. The repository's tiny merges table
(assets/bpe_tiny_test_vocab.txt.gz, `TINY_VOCAB`) drives the tests and the
smoke runs. The empty prompt's ids are fixed under the production layout and
need no vocabulary (`tokenize_empty`). ftfy's mojibake repair runs where ftfy
is importable (an identity on ASCII), as in the JAX package; the pattern
needs the `regex` module (\\p{L} / \\p{N}), as there.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import List, Optional, Sequence

import numpy as np

SOT = 49406
EOT = 49407
CONTEXT_LENGTH = 77

TINY_VOCAB = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "bpe_tiny_test_vocab.txt.gz")


@functools.lru_cache()
def bytes_to_unicode():
    """The reversible byte -> printable-unicode map of CLIP's vocabularies:
    printable bytes map to themselves, the rest to 256 + n."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) \
        + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word):
    return {(a, b) for a, b in zip(word, word[1:])}


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


def _pattern():
    import regex

    return regex.compile(r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|"""
                         r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""", regex.IGNORECASE)


class ClipBPETokenizer:
    """BPE encoder over a CLIP-format merges file (plain or gzipped; the first
    line a header, then one merge pair a line, highest priority first). The
    vocabulary is [256 byte symbols, their </w> forms, merges..., SOT, EOT]:
    with the production 48,894-merge file the 49,408-id layout (SOT 49406,
    EOT 49407) the text towers expect."""

    def __init__(self, bpe_path: str, context_length: int = CONTEXT_LENGTH):
        self.context_length = context_length
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in lines[1: 49152 - 256 - 2 + 1]]
        merges = [m for m in merges if len(m) == 2]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<start_of_text>", "<end_of_text>"]
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.sot = self.encoder["<start_of_text>"]
        self.eot = self.encoder["<end_of_text>"]
        # literal special tokens in the text stay one id each (open_clip's cache seed)
        self._cache = {"<start_of_text>": "<start_of_text>", "<end_of_text>": "<end_of_text>"}
        self._pat = _pattern()

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = " ".join(_basic_clean(text).split()).lower()
        for token in self._pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Sequence[str], context_length: Optional[int] = None) -> np.ndarray:
        n = context_length or self.context_length
        out = np.zeros((len(texts), n), dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > n:
                ids = ids[:n]
                ids[-1] = self.eot
            out[row, : len(ids)] = ids
        return out


def default_bpe_path() -> Optional[str]:
    """$VIDSEG_BPE_PATH, then the conventional checkpoint-directory places."""
    cands = [os.environ.get("VIDSEG_BPE_PATH")]
    for root in ("checkpoints", os.path.expanduser("~/.cache/vidseg")):
        cands.append(os.path.join(root, "bpe_simple_vocab_16e6.txt.gz"))
    return next((c for c in cands if c and os.path.exists(c)), None)


@functools.lru_cache(maxsize=4)
def _tokenizer(bpe_path: str) -> ClipBPETokenizer:
    return ClipBPETokenizer(bpe_path)


def tokenize_empty(batch: int = 1, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """[SOT, EOT] zero-padded to `context_length`, as open_clip.tokenize
    frames the empty prompt."""
    tokens = np.zeros((batch, context_length), dtype=np.int32)
    tokens[:, 0] = SOT
    tokens[:, 1] = EOT
    return tokens


def tokenize(texts: Sequence[str], context_length: int = CONTEXT_LENGTH,
             bpe_path: Optional[str] = None) -> np.ndarray:
    """[SOT, BPE ids..., EOT] zero-padded to `context_length`. Empty prompts
    need no vocabulary; others use `bpe_path` or the discovered production
    vocabulary."""
    if all(t.strip() == "" for t in texts):
        return tokenize_empty(len(texts), context_length)
    path = bpe_path or default_bpe_path()
    if path is None:
        raise ValueError("non-empty prompts need the CLIP BPE vocabulary (bpe_simple_vocab_16e6.txt.gz): pass "
                         "bpe_path= or set $VIDSEG_BPE_PATH (the repository has only TINY_VOCAB)")
    return _tokenizer(path)(texts, context_length)
