"""The port's wire codecs against the JAX package's, byte for byte: the
flexible-tensor header (``tensors/meta.py``) and the sparse COO chunk
(``tensors/sparse.py``). Every case encodes with one package and decodes
with the other, both ways, on the same numpy-seeded arrays; bytes and
decoded arrays are held exactly. The cases are those of
``tests/test_tensors_meta.py``: header roundtrip, array roundtrip,
bfloat16, bad magic, truncated, multi-tensor frame and the sparse cases.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.tensors import meta as jmeta
from nnstreamer_tpu.tensors import sparse as jsparse
from nnstreamer_tpu.tensors.spec import DType as JDType
from nnstreamer_tpu.tensors.spec import TensorFormat as JFormat
from nnstreamer_tpu_torch.tensors import meta as tmeta
from nnstreamer_tpu_torch.tensors import sparse as tsparse
from nnstreamer_tpu_torch.tensors.spec import DType, TensorFormat

PAIRS = {"port→jax": (tmeta, jmeta), "jax→port": (jmeta, tmeta)}
SPARSE_PAIRS = {"port→jax": (tsparse, jsparse), "jax→port": (jsparse, tsparse)}

DTYPES = ["int8", "uint8", "int16", "uint16", "int32", "uint32", "int64",
          "uint64", "float16", "float32", "float64", "bool"]


def _array(dtype, shape, seed=0, density=1.0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-100, 100, shape)
    a[rng.random(shape) >= density] = 0
    return a.astype(dtype)


def test_header_constants_match():
    assert tmeta.HEADER_SIZE == jmeta.HEADER_SIZE == 96
    assert tmeta.MAGIC == jmeta.MAGIC and tmeta.VERSION == jmeta.VERSION
    assert [d.value for d in tmeta._DTYPE_CODES] == [d.value for d in jmeta._DTYPE_CODES]
    assert [f.value for f in tmeta._FORMAT_CODES] == [f.value for f in jmeta._FORMAT_CODES]


@pytest.mark.parametrize("fmt", ["static", "flexible", "sparse"])
@pytest.mark.parametrize("shape", [(), (5,), (1, 224, 224, 3), tuple(range(1, 17))])
def test_header_pack_bytes_equal(shape, fmt):
    t = tmeta.FlexTensorMeta(DType.FLOAT32, shape, TensorFormat(fmt), 3, 100)
    j = jmeta.FlexTensorMeta(JDType.FLOAT32, shape, JFormat(fmt), 3, 100)
    assert t.pack() == j.pack()
    back = jmeta.FlexTensorMeta.unpack(t.pack())
    assert back == j
    assert tmeta.FlexTensorMeta.unpack(j.pack()) == t


@pytest.mark.parametrize("way", sorted(PAIRS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_array_roundtrip_across_packages(dtype, way):
    enc, dec = PAIRS[way]
    a = _array(dtype, (2, 3, 4), seed=DTYPES.index(dtype))
    buf = enc.FlexTensorMeta.encode_array(a)
    assert buf == jmeta.FlexTensorMeta.encode_array(a)  # the same bytes
    b, used = dec.FlexTensorMeta.decode_array(buf)
    assert used == len(buf)
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "bfloat16"])
def test_torch_tensor_encodes_as_its_numpy_twin(dtype):
    """The port's encoder also takes torch tensors: the same bytes as the
    JAX package's encoder on the numpy array."""
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    if dtype == "bfloat16":
        t = torch.from_numpy(a).to(torch.bfloat16)
        ref = a.astype(JDType.BFLOAT16.np_dtype)
    else:
        t = torch.from_numpy(a.astype(dtype))
        ref = a.astype(dtype)
    assert tmeta.FlexTensorMeta.encode_array(t) == jmeta.FlexTensorMeta.encode_array(ref)


@pytest.mark.parametrize("way", sorted(PAIRS))
def test_bfloat16_roundtrip(way):
    enc, dec = PAIRS[way]
    a = np.arange(8).astype(JDType.BFLOAT16.np_dtype)
    buf = enc.FlexTensorMeta.encode_array(a)
    assert buf == jmeta.FlexTensorMeta.encode_array(a)
    b, _ = dec.FlexTensorMeta.decode_array(buf)
    np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))


@pytest.mark.parametrize("way", sorted(PAIRS))
def test_bad_magic(way):
    enc, dec = PAIRS[way]
    d = (DType if enc is tmeta else JDType).UINT8
    buf = bytearray(enc.FlexTensorMeta(d, (2,)).pack())
    buf[0] = 0xFF
    with pytest.raises(ValueError, match="magic"):
        dec.FlexTensorMeta.unpack(bytes(buf))


@pytest.mark.parametrize("way", sorted(PAIRS))
def test_truncated(way):
    enc, dec = PAIRS[way]
    buf = enc.FlexTensorMeta.encode_array(np.zeros(10, np.float32))[:-4]
    with pytest.raises(ValueError, match="truncated"):
        dec.FlexTensorMeta.decode_array(buf)
    with pytest.raises(ValueError, match="too small"):
        dec.FlexTensorMeta.unpack(buf[:50])


@pytest.mark.parametrize("way", sorted(PAIRS))
def test_multi_tensor_frame(way):
    enc, dec = PAIRS[way]
    arrays = [np.ones((2, 2), np.uint8), np.zeros((5,), np.float64),
              _array("int16", (3, 1, 2), seed=7)]
    buf = enc.encode_frame_tensors(arrays)
    assert buf == jmeta.encode_frame_tensors(arrays)
    out = dec.decode_frame_tensors(buf)
    assert len(out) == 3
    for a, b in zip(arrays, out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("way", sorted(SPARSE_PAIRS))
@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "float64"])
def test_sparse_roundtrip_across_packages(dtype, density, way):
    enc, dec = SPARSE_PAIRS[way]
    a = _array(dtype, (4, 8, 3), seed=11, density=density)
    buf = enc.sparse_encode(a)
    assert buf == jsparse.sparse_encode(a)  # the same bytes
    dense, used = dec.sparse_decode(buf)
    assert used == len(buf)
    assert dense.dtype == a.dtype
    np.testing.assert_array_equal(a, dense)
    assert tsparse.sparse_density(a) == jsparse.sparse_density(a)


def test_sparse_compresses_and_is_tagged():
    a = np.zeros((100, 100), np.float32)
    a[0, 0] = 1
    buf = tsparse.sparse_encode(a)
    assert len(buf) < a.nbytes
    assert tmeta.FlexTensorMeta.unpack(buf).format is TensorFormat.SPARSE
    assert jmeta.FlexTensorMeta.unpack(buf).format is JFormat.SPARSE
    assert tsparse.sparse_density(np.array([1, 1, 1, 0, 0, 0, 0, 0, 0, 0])) == pytest.approx(0.3)


@pytest.mark.parametrize("way", sorted(PAIRS))
def test_sparse_decode_rejects_non_sparse(way):
    enc, _ = PAIRS[way]
    dec = tsparse if enc is jmeta else jsparse
    buf = enc.FlexTensorMeta.encode_array(np.ones(4, np.int32))
    with pytest.raises(ValueError, match="not a sparse"):
        dec.sparse_decode(buf)
