"""The C entry points of the port's CUDA libraries against their
declarations (`ops/cuda/_build.ENTRIES`), on the CPU: a Python argument
list that disagrees with its `extern "C"` signature would only show on
the card, as a wrong pointer or a wrong number.

Every `extern "C"` function of `ops/cuda/csrc/<stem>.cu` is declared by
the module that wraps it, in the library of its source, with the same
argument and return types: a pointer (`T*`, `const T*`) is `c_void_p`,
`int`, `long` and `float` their ctypes, and a `*_launch` symbol takes
the stream (`void* stream`) last. Also `_build.check_inputs`, which every
wrapper runs before it passes its tensors' pointers.
"""

import ctypes
import re

import pytest
import torch

from aura_snn_rag_tpu_torch.ops import experts  # noqa: F401
from aura_snn_rag_tpu_torch.ops.cuda import (  # noqa: F401
    _build, adamw, annex, flat_scan, ivf_scan, kda)

C_TYPES = {"int": ctypes.c_int, "long": ctypes.c_long,
           "float": ctypes.c_float}


def _source(stem):
    """`csrc/<stem>.cu` without its line comments."""
    text = (_build.CSRC / f"{stem}.cu").read_text()
    return re.sub(r"//[^\n]*", "", text)


def c_signatures():
    """{symbol: (stem, return ctype, [(ctype, parameter name)])} of every
    `extern "C"` function in the sources."""
    out = {}
    for stem in _build.SOURCES:
        for ret, symbol, params in re.findall(
                r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)',
                _source(stem)):
            args = []
            for param in params.split(","):
                words = param.replace("*", " * ").split()
                if "*" in words:
                    args.append((ctypes.c_void_p, words[-1]))
                else:
                    assert len(words) == 2, (symbol, param)
                    args.append((C_TYPES[words[0]], words[-1]))
            out[symbol] = (stem, C_TYPES[ret], args)
    return out


SIGNATURES = c_signatures()


@pytest.mark.parametrize("symbol", sorted(set(SIGNATURES)
                                          | set(_build.ENTRIES)))
def test_entry_matches_its_c_signature(symbol):
    assert symbol in SIGNATURES, f"{symbol} is declared but not in csrc/"
    assert symbol in _build.ENTRIES, f"{symbol} is not declared"
    stem, ret, args = SIGNATURES[symbol]
    entry = _build.ENTRIES[symbol]
    assert entry.stem == stem
    assert entry.restype is ret
    assert entry.argtypes == tuple(t for t, _ in args)
    if symbol.endswith("_launch"):
        assert args[-1] == (ctypes.c_void_p, "stream")
        assert ret is ctypes.c_int
    else:
        assert "stream" not in [name for _, name in args]


def test_every_extern_c_function_is_read():
    for stem in _build.SOURCES:
        read = [s for s, (st, _, _) in SIGNATURES.items() if st == stem]
        assert read and len(read) == _source(stem).count('extern "C"')


def _misaligned(n):
    """A contiguous f32 [n] starting 4 bytes past a 16-byte boundary."""
    base = torch.zeros(n + 4)
    off = (-base.data_ptr() % 16) // 4 + 1
    return base[off:off + n]


F32, BF16 = torch.float32, torch.bfloat16


# `check_inputs`, which every wrapper runs before it passes pointers:
# each case the inputs and options, and the error it raises (None: none)
@pytest.mark.parametrize("case", [
    "fine", "dtype", "strided", "misaligned", "misaligned_unread",
    "narrow_rows"])
def test_check_inputs(case):
    x, y = torch.zeros(4, 8, dtype=BF16), torch.zeros(4)
    pairs, kw, err = {
        "fine": ([(x, BF16), (y, F32)], {"whole_rows": True}, None),
        "dtype": ([(x, BF16), (y, torch.int32)], {}, TypeError),
        "strided": ([(x, BF16), (torch.zeros(4, 2)[:, 0], F32)], {},
                    ValueError),
        "misaligned": ([(x, BF16), (_misaligned(4), F32)], {}, ValueError),
        "misaligned_unread": ([(x, BF16), (_misaligned(4), F32)],
                              {"aligned": 1}, None),
        "narrow_rows": ([(torch.zeros(4, 4, dtype=BF16), BF16)],
                        {"whole_rows": True}, ValueError),
    }[case]
    if err is None:
        _build.check_inputs("k", *pairs, **kw)
    else:
        with pytest.raises(err, match="^k: "):
            _build.check_inputs("k", *pairs, **kw)
