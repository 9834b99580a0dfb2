"""Text -> vocabulary / doc-term matrix tooling, copied from
``lightctr_tpu/data/text.py``.

Parity with the reference's ``data/proc_text_topic.py`` (vocab + doc-term
matrix that feeds the PLSA trainer) and the vocab format consumed by
``Train_Embed_Algo`` (``vocab.txt`` lines ``id word count``).
"""

from __future__ import annotations

import collections
import re
from typing import Dict, List, Tuple

import numpy as np

_TOKEN = re.compile(r"[A-Za-z']+")


def tokenize(text: str) -> List[str]:
    return [t.lower() for t in _TOKEN.findall(text)]


def build_vocab(
    docs_tokens: List[List[str]], max_size: int = 5000, min_count: int = 1
) -> Tuple[List[str], np.ndarray, Dict[str, int]]:
    """Frequency-sorted vocabulary; returns (words, counts, word->id)."""
    counter = collections.Counter(t for doc in docs_tokens for t in doc)
    items = [(w, c) for w, c in counter.most_common(max_size) if c >= min_count]
    words = [w for w, _ in items]
    counts = np.asarray([c for _, c in items], np.int64)
    return words, counts, {w: i for i, w in enumerate(words)}


def save_vocab(path: str, words: List[str], counts: np.ndarray) -> None:
    """Write the reference's ``id word count`` format."""
    with open(path, "w") as f:
        for i, (w, c) in enumerate(zip(words, counts)):
            f.write(f"{i} {w} {int(c)}\n")


def doc_term_matrix(
    docs_tokens: List[List[str]], word_to_id: Dict[str, int]
) -> np.ndarray:
    """[docs, vocab] count matrix (proc_text_topic.py output, PLSA input)."""
    m = np.zeros((len(docs_tokens), len(word_to_id)), np.float32)
    for d, doc in enumerate(docs_tokens):
        for t in doc:
            i = word_to_id.get(t)
            if i is not None:
                m[d, i] += 1.0
    return m


def docs_to_ids(
    docs_tokens: List[List[str]], word_to_id: Dict[str, int]
) -> List[np.ndarray]:
    """Token streams -> id arrays (the word2vec corpus form)."""
    return [
        np.asarray([word_to_id[t] for t in doc if t in word_to_id], np.int32)
        for doc in docs_tokens
    ]
