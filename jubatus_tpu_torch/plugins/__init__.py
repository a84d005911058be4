"""Built-in fv_converter plugins (copy of ``jubatus_tpu/plugins/``;
≙ plugin/src/fv_converter/).

Loaded by name or path through the dynamic type mechanism
(``jubatus_tpu_torch.core.fv.plugins``); a bare name resolves against this
directory. The reference ships three:

- ``mecab_splitter``  — Japanese morphological tokenizer (needs MeCab)
- ``ux_splitter``     — dictionary keyword extraction (trie scan)
- ``image_feature``   — image descriptors over binary values (needs OpenCV)

Each module exposes ``create(params)`` like the reference's
``extern "C" create`` (mecab_splitter.cpp:203-230). The optional
libraries load when a plugin is created, never at import.
"""
