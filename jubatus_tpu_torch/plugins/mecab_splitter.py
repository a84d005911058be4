"""Japanese morphological tokenizer (copy of
``jubatus_tpu/plugins/mecab_splitter.py``; ≙ plugin/src/fv_converter/
mecab_splitter.cpp) — wraps MeCab when the binding is installed.

config (same params as the reference, mecab_splitter.cpp:203-230):
    {"method": "dynamic", "path": "mecab_splitter", "function": "create",
     "arg": "", "ngram": "1", "base": "false"}

``arg`` passes through to the MeCab tagger; ``ngram`` joins consecutive
surface forms into token n-grams; ``base`` emits base forms (feature
column 7) instead of surfaces.
"""

from __future__ import annotations

from typing import Dict, List


class MecabSplitter:
    def __init__(self, arg: str = "", ngram: int = 1, base: bool = False) -> None:
        try:
            import MeCab  # noqa: PLC0415
        except ImportError as e:  # pragma: no cover - env without mecab
            raise RuntimeError(
                "mecab_splitter requires the 'mecab-python3' package"
            ) from e
        self.tagger = MeCab.Tagger(arg)
        self.ngram = max(1, ngram)
        self.base = base

    def _tokens(self, text: str) -> List[str]:
        out = []
        node = self.tagger.parseToNode(text)
        while node is not None:
            if node.surface:
                if self.base:
                    feats = node.feature.split(",")
                    out.append(feats[6] if len(feats) > 6 and feats[6] != "*"
                               else node.surface)
                else:
                    out.append(node.surface)
            node = node.next
        return out

    def split(self, text: str) -> List[str]:
        toks = self._tokens(text)
        n = self.ngram
        if n == 1:
            return toks
        return ["".join(toks[i : i + n]) for i in range(len(toks) - n + 1)]


def create(params: Dict[str, str]) -> MecabSplitter:
    base_str = params.get("base", "false")
    if base_str not in ("true", "false"):
        raise ValueError("base must be a boolean value")
    return MecabSplitter(
        arg=params.get("arg", ""),
        ngram=int(params.get("ngram", "1")),
        base=base_str == "true",
    )
