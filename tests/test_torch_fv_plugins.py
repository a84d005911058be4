"""The port's converter plugins (``jubatus_tpu_torch/core/fv/plugins.py``,
``jubatus_tpu_torch/plugins/``, the ``.so`` loader in
``jubatus_tpu_torch/native``), mirroring ``tests/test_fv_plugins.py`` and
the splitter cases of ``tests/test_native.py``: loading by path, bare names
against the port's own plugin directory, ux_splitter, num and binary
plugins, the error paths, the module cache, a ``.so`` built with g++ from
``native/sample_ngram_splitter.cpp``. Parity: a ``dynamic`` string, num and
binary type and a ``.so`` splitter give the same ``SparseVector`` in both
packages. MeCab is absent, so its case skips (as the JAX package's does)."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from jubatus_tpu_torch.core.datum import Datum
from jubatus_tpu_torch.core.fv import plugins
from jubatus_tpu_torch.core.fv.converter import (ConverterError,
                                                 make_fv_converter)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def _clear_plugin_cache():
    plugins.clear_cache()
    yield
    plugins.clear_cache()


def test_load_plugin_from_path(tmp_path):
    plug = tmp_path / "shout_splitter.py"
    plug.write_text(
        "def create(params):\n"
        "    suffix = params.get('suffix', '!')\n"
        "    return lambda text: [w + suffix for w in text.split()]\n"
    )
    conf = {
        "string_types": {
            "shout": {"method": "dynamic", "path": str(plug),
                      "function": "create", "suffix": "!!"},
        },
        "string_rules": [{"key": "*", "type": "shout",
                          "sample_weight": "bin", "global_weight": "bin"}],
    }
    conv = make_fv_converter(conf)
    named = conv.convert_named(Datum({"msg": "hello world"}))
    assert any("hello!!" in k for k in named)
    assert any("world!!" in k for k in named)


def test_plugin_object_with_split_method(tmp_path):
    plug = tmp_path / "obj_splitter.py"
    plug.write_text(
        "class S:\n"
        "    def split(self, text):\n"
        "        return list(text)\n"
        "def create(params):\n"
        "    return S()\n"
    )
    conf = {
        "string_types": {"chars": {"method": "dynamic", "path": str(plug)}},
        "string_rules": [{"key": "*", "type": "chars",
                          "sample_weight": "tf", "global_weight": "bin"}],
    }
    named = make_fv_converter(conf).convert_named(Datum({"k": "aab"}))
    tf = {k: v for k, v in named.items()}
    assert any(v == 2.0 for v in tf.values())  # 'a' twice


def test_ux_splitter_builtin_by_name(tmp_path):
    kw = tmp_path / "kw.txt"
    kw.write_text("jubatus\ntpu\nbat\n")
    conf = {
        "string_types": {
            "ux": {"method": "dynamic", "path": "ux_splitter",
                   "function": "create", "dict_path": str(kw)},
        },
        "string_rules": [{"key": "*", "type": "ux",
                          "sample_weight": "bin", "global_weight": "bin"}],
    }
    named = make_fv_converter(conf).convert_named(
        Datum({"t": "jubatus on tpu"}))
    terms = {k.split("$")[1].split("@")[0] for k in named}
    assert terms == {"jubatus", "tpu", "bat"}  # 'bat' inside 'jubatus'


def test_num_plugin(tmp_path):
    plug = tmp_path / "squarer.py"
    plug.write_text(
        "def create(params):\n"
        "    return lambda key, value: [(key + '@sq', value * value)]\n"
    )
    conf = {
        "num_types": {"sq": {"method": "dynamic", "path": str(plug)}},
        "num_rules": [{"key": "*", "type": "sq"}],
    }
    named = make_fv_converter(conf).convert_named(Datum({"x": 3.0}))
    assert named["x@sq"] == 9.0


def test_binary_plugin(tmp_path):
    plug = tmp_path / "bytecount.py"
    plug.write_text(
        "def create(params):\n"
        "    return lambda key, data: [(key + '$len', float(len(data)))]\n"
    )
    conf = {
        "binary_types": {"len": {"method": "dynamic", "path": str(plug)}},
        "binary_rules": [{"key": "*", "type": "len"}],
    }
    d = Datum()
    d.add("blob", b"12345")
    named = make_fv_converter(conf).convert_named(d)
    assert named["blob$len"] == 5.0


def test_missing_plugin_path_raises():
    conf = {
        "string_types": {"x": {"method": "dynamic", "path": "/nope/missing.py"}},
        "string_rules": [{"key": "*", "type": "x"}],
    }
    with pytest.raises(ConverterError, match="not found"):
        make_fv_converter(conf)


def test_plugin_without_factory_raises(tmp_path):
    plug = tmp_path / "empty.py"
    plug.write_text("x = 1\n")
    conf = {"string_types": {"x": {"method": "dynamic", "path": str(plug)}},
            "string_rules": [{"key": "*", "type": "x"}]}
    with pytest.raises(ConverterError, match="factory"):
        make_fv_converter(conf)


def test_module_cache_reused(tmp_path):
    plug = tmp_path / "counted.py"
    plug.write_text(
        "CALLS = []\n"
        "def create(params):\n"
        "    CALLS.append(1)\n"
        "    return lambda text: [text]\n"
    )
    p = {"method": "dynamic", "path": str(plug)}
    s1 = plugins.load_string_plugin(dict(p))
    s2 = plugins.load_string_plugin(dict(p))
    assert s1("a") == s2("a") == ["a"]
    mod = plugins._load_module(str(plug))
    assert len(mod.CALLS) == 2  # two factory calls, ONE module import


def test_binary_rule_unknown_type_rejected():
    conf = {"binary_rules": [{"key": "*", "type": "ghost"}]}
    with pytest.raises(ConverterError, match="binary rule"):
        make_fv_converter(conf)


def test_mecab_plugin_if_available():
    pytest.importorskip("MeCab")
    from jubatus_tpu_torch.plugins.mecab_splitter import create

    sp = create({"ngram": "1", "base": "false"})
    assert isinstance(sp.split("これはテストです"), list)


def test_image_plugin_if_available(tmp_path):
    cv2 = pytest.importorskip("cv2")
    import numpy as np

    from jubatus_tpu_torch.plugins.image_feature import create

    img = (np.random.default_rng(0).random((32, 32)) * 255).astype("uint8")
    ok, buf = cv2.imencode(".png", img)
    assert ok
    feats = list(create({"algorithm": "dense", "resize": "true",
                         "width": "8", "height": "8"}).extract("im", buf.tobytes()))
    assert len(feats) == 64


# -- the .so splitter ABI -------------------------------------------------------


@pytest.fixture(scope="module")
def sample_splitter_so(tmp_path_factory):
    """``native/sample_ngram_splitter.cpp`` built with g++ into a tmp dir."""
    src = os.path.join(ROOT, "native", "sample_ngram_splitter.cpp")
    out = str(tmp_path_factory.mktemp("so") / "libsample_ngram_splitter.so")
    try:
        res = subprocess.run(
            ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", out, src],
            capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        pytest.skip(f"cannot build sample splitter: {e}")
    if res.returncode != 0:
        pytest.skip("cannot build sample splitter: "
                    + res.stderr.decode()[-300:])
    return out


def test_native_splitter_plugin(sample_splitter_so):
    from jubatus_tpu_torch.native import load_native_splitter

    split = load_native_splitter(sample_splitter_so, {"char_num": "2"})
    assert split("abcd") == ["ab", "bc", "cd"]
    assert split("a") == []


def test_native_splitter_through_converter(sample_splitter_so):
    conf = {
        "string_types": {
            "bigram": {"method": "dynamic", "path": sample_splitter_so,
                       "char_num": "2"},
        },
        "string_rules": [{"key": "*", "type": "bigram",
                          "sample_weight": "bin", "global_weight": "bin"}],
    }
    named = make_fv_converter(conf).convert_named(Datum({"t": "abc"}))
    terms = {k.split("$")[1].split("@")[0] for k in named}
    assert terms == {"ab", "bc"}


def test_native_splitter_bad_params(sample_splitter_so):
    from jubatus_tpu_torch.native import load_native_splitter

    with pytest.raises(ConverterError, match="rejected"):
        load_native_splitter(sample_splitter_so, {"char_num": "0"})


# -- bare names resolve against the port's own directory --------------------------


def test_bare_name_resolves_to_the_port_plugin_dir():
    path = plugins.resolve_path("ux_splitter")
    assert os.path.dirname(path) == plugins.BUILTIN_PLUGIN_DIR
    assert os.path.samefile(path, os.path.join(ROOT, "jubatus_tpu_torch",
                                               "plugins", "ux_splitter.py"))
    assert os.sep + "jubatus_tpu_torch" + os.sep in path
    assert os.sep + "jubatus_tpu" + os.sep not in path


def test_port_and_jax_plugin_modules_stay_apart(tmp_path):
    """One plugin file loaded by both packages in one process: two module
    objects under two prefixes, neither clobbering the other."""
    from jubatus_tpu.core.fv import plugins as jplugins

    plug = tmp_path / "twice.py"
    plug.write_text("def create(params):\n    return lambda t: [t]\n")
    pmod = plugins._load_module(str(plug))
    jmod = jplugins._load_module(str(plug))
    assert pmod is not jmod
    assert pmod.__name__.startswith("jubatus_tpu_torch_plugin_twice_")
    assert jmod.__name__.startswith("jubatus_tpu_plugin_twice_")
    assert sys.modules[pmod.__name__] is pmod
    assert sys.modules[jmod.__name__] is jmod
    jplugins.clear_cache()


def test_optional_libraries_load_with_the_plugin_not_the_package():
    """Importing the port's plugin modules loads neither cv2 nor MeCab."""
    probe = ("import sys, importlib\n"
             "for m in ('image_feature', 'mecab_splitter', 'ux_splitter'):\n"
             "    importlib.import_module('jubatus_tpu_torch.plugins.' + m)\n"
             "import jubatus_tpu_torch.core.fv.plugins\n"
             "print(sorted(m for m in ('cv2', 'MeCab') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- parity: the same SparseVector from a plugin converter in each package --------


def _both(conf):
    from jubatus_tpu.core.fv.converter import make_fv_converter as jmake

    return make_fv_converter(conf), jmake(conf)


def _same_vectors(conf, datums):
    from jubatus_tpu.core.datum import Datum as JDatum

    pconv, jconv = _both(conf)
    for sv, bv, nv in datums:
        pd, jd = Datum(sv), JDatum(sv)
        for k, v in bv:
            pd.add(k, v)
            jd.add(k, v)
        for k, v in nv:
            pd.add(k, v)
            jd.add(k, v)
        assert pconv.convert(pd) == jconv.convert(jd)
        assert pconv.convert_named(pd) == jconv.convert_named(jd)
    pb = pconv.convert_batch([Datum(sv) for sv, _b, _n in datums])
    jb = jconv.convert_batch([JDatum(sv) for sv, _b, _n in datums])
    for f in ("row_offsets", "indices", "values"):
        assert np.array_equal(np.asarray(getattr(pb, f)),
                              np.asarray(getattr(jb, f))), f


def _texts(seed, n=12):
    rng = np.random.default_rng(seed)
    words = ["jubatus", "tpu", "bat", "on", "the", "card", "hopper"]
    return [" ".join(rng.choice(words, size=int(rng.integers(1, 6))))
            for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1])
def test_parity_dynamic_string_types(tmp_path, seed):
    """ux_splitter by bare name (each package its own copy) and a plugin
    by path, under tf / idf weights."""
    kw = tmp_path / "kw.txt"
    kw.write_text("jubatus\ntpu\nbat\nhop\n")
    plug = tmp_path / "words.py"
    plug.write_text("def create(params):\n"
                    "    return lambda text: text.split()\n")
    conf = {
        "string_types": {
            "ux": {"method": "dynamic", "path": "ux_splitter",
                   "function": "create", "dict_path": str(kw)},
            "w": {"method": "dynamic", "path": str(plug)},
        },
        "string_rules": [
            {"key": "t", "type": "ux", "sample_weight": "tf",
             "global_weight": "bin"},
            {"key": "*", "type": "w", "sample_weight": "log_tf",
             "global_weight": "idf"}],
    }
    _same_vectors(conf, [({"t": t, "u": t[::-1]}, [], [])
                         for t in _texts(seed)])


def test_parity_dynamic_num_and_binary_types(tmp_path):
    plug = tmp_path / "sq.py"
    plug.write_text("def create(params):\n"
                    "    return lambda key, v: [(key + '@sq', v * v),\n"
                    "                           (key + '@half', v / 2)]\n")
    blob = tmp_path / "blen.py"
    blob.write_text("def create(params):\n"
                    "    return lambda key, data: [(key + '$len',\n"
                    "                               float(len(data)))]\n")
    conf = {
        "num_types": {"sq": {"method": "dynamic", "path": str(plug)}},
        "num_rules": [{"key": "*", "type": "sq"}],
        "binary_types": {"len": {"method": "dynamic", "path": str(blob)}},
        "binary_rules": [{"key": "*", "type": "len"}],
    }
    rng = np.random.default_rng(4)
    datums = [({}, [("b%d" % i, bytes(int(rng.integers(1, 50))))],
               [("x", float(rng.normal())), ("y", float(rng.normal()))])
              for i in range(8)]
    _same_vectors(conf, datums)


def test_parity_so_splitter(sample_splitter_so):
    conf = {
        "string_types": {"bigram": {"method": "dynamic",
                                    "path": sample_splitter_so,
                                    "char_num": "2"}},
        "string_rules": [{"key": "*", "type": "bigram",
                          "sample_weight": "tf", "global_weight": "bin"}],
    }
    _same_vectors(conf, [({"t": t}, [], []) for t in _texts(7)])
