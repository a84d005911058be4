"""Dictionary keyword extractor (copy of ``jubatus_tpu/plugins/ux_splitter.py``;
≙ plugin/src/fv_converter/ux_splitter.cpp).

The reference builds a ux-trie from a keyword file (one keyword per line)
and emits every occurrence of any dictionary keyword in the text. Here the
trie is a plain prefix map; matching is the same greedy scan over all
start offsets, emitting every dictionary hit (overlaps included).

config:
    {"method": "dynamic", "path": "ux_splitter", "function": "create",
     "dict_path": "/path/keywords.txt"}
"""

from __future__ import annotations

from typing import Dict, List


class _Trie:
    __slots__ = ("children", "terminal")

    def __init__(self) -> None:
        self.children: Dict[str, "_Trie"] = {}
        self.terminal = False

    def insert(self, word: str) -> None:
        node = self
        for ch in word:
            node = node.children.setdefault(ch, _Trie())
        node.terminal = True


class UxSplitter:
    def __init__(self, keywords: List[str]) -> None:
        self.root = _Trie()
        for kw in keywords:
            if kw:
                self.root.insert(kw)

    def split(self, text: str) -> List[str]:
        out: List[str] = []
        n = len(text)
        for start in range(n):
            node = self.root
            for i in range(start, n):
                node = node.children.get(text[i])
                if node is None:
                    break
                if node.terminal:
                    out.append(text[start : i + 1])
        return out


def create(params: Dict[str, str]) -> UxSplitter:
    dict_path = params.get("dict_path")
    if not dict_path:
        raise ValueError('ux_splitter needs "dict_path"')
    with open(dict_path, encoding="utf-8") as f:
        keywords = [line.rstrip("\r\n") for line in f]
    return UxSplitter(keywords)
