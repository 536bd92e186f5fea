"""index.route: one function picks every search route and scan."""

import dataclasses

import jax
import pytest

from qadc_tpu.index import route


@dataclasses.dataclass
class _PQ:
    sq_count: int = 16
    sq_bits: int = 4


@dataclasses.dataclass
class _IVF:
    pq: _PQ = dataclasses.field(default_factory=_PQ)
    part_count: int = 256
    part_pad: int = 4096


@dataclasses.dataclass
class _Flat:
    pq: _PQ = dataclasses.field(default_factory=_PQ)
    n_pad: int = 1 << 20


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def test_cpu_defaults_are_plain():
    ix, fx = _IVF(), _Flat()
    assert route.choose("ivf_qadc", ix, q=128, ma=24) == route.Route("loop", "xla")
    assert route.choose("ivf_qadc", ix, q=1, ma=24) == route.Route("loop", "xla")
    assert route.choose("ivf_adc", ix) == route.Route("loop", "xla")
    assert route.choose("flat_qadc", fx) == route.Route("loop", "xla")
    # 16-bit grouped ADC is plain XLA on every platform.
    ix16 = _IVF(pq=_PQ(8, 16))
    assert route.choose("ivf_adc", ix16) == route.Route("grouped", "xla")


def test_gpu_routes(on_gpu):
    ix, fx = _IVF(), _Flat()
    assert route.scan_impl() == "triton"
    assert route.choose("ivf_qadc", ix, q=1, ma=24) == route.Route("direct", "xla")
    assert route.choose("ivf_qadc", ix, q=32, ma=24) == route.Route("grouped", "triton")
    assert route.choose("ivf_qadc", ix, q=128, ma=24) == route.Route("grouped", "triton")
    assert route.choose("ivf_adc", _IVF(pq=_PQ(8, 8))) == route.Route("grouped", "xla")
    assert route.choose("ivf_adc", ix) == route.Route("grouped", "xla")
    assert route.choose("flat_qadc", fx) == route.Route("window", "triton")
    assert route.choose("flat_sharded_qadc", fx, q=1 << 18, r=200) == route.Route(
        "window", "triton")


def test_gpu_geometry_rules(on_gpu):
    # sq_count outside (16, 32), unaligned partitions, rerank off, saturate:
    # the grouped/direct defaults fall back as their geometry rules say.
    assert route.choose("ivf_qadc", _IVF(pq=_PQ(8)), q=128, ma=24).path == "loop"
    assert route.choose("ivf_qadc", _IVF(part_pad=4000), q=128, ma=24).path == "loop"
    assert route.choose("ivf_qadc", _IVF(), q=1, ma=24, rerank=False).path == "grouped"
    assert route.choose("ivf_qadc", _IVF(), q=1, ma=24, saturate=True).path == "grouped"
    assert route.choose("flat_qadc", _Flat(n_pad=2048), r=100).path == "loop"
    # Sparse probes (density <= 1.5) go direct whatever the volume.
    sparse = _IVF(part_count=65536, part_pad=8192)
    assert route.choose("ivf_qadc", sparse, q=512, ma=2).path == "direct"


def test_explicit_choice_wins():
    ix = _IVF()
    assert route.choose("ivf_qadc", ix, q=128, ma=24, grouped=True) == route.Route(
        "grouped", "xla")
    assert route.choose("ivf_qadc", ix, q=128, ma=24, direct=True).path == "direct"
    assert route.choose("ivf_adc", ix, grouped=True).path == "grouped"
    assert route.choose("flat_qadc", _Flat(), grouped=True).path == "window"


def test_interpret_takes_gpu_routes_on_cpu():
    ix = _IVF()
    assert route.choose("ivf_qadc", ix, q=128, ma=24, interpret=True) == route.Route(
        "grouped", "interpret")
    assert route.choose("ivf_qadc", ix, q=1, ma=24, interpret=True).path == "direct"
    assert route.choose("flat_qadc", _Flat(), interpret=True) == route.Route(
        "window", "interpret")


def test_interpret_raises_off_cpu(on_gpu):
    with pytest.raises(ValueError, match="interpret"):
        route.choose("ivf_qadc", _IVF(), q=128, ma=24, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        route.scan_impl(interpret=True)


def test_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown search op"):
        route.choose("ivf_pq", _IVF())


def test_search_entry_points_raise_interpret_on_gpu(on_gpu, rng):
    """interpret=True never silently interprets on an accelerator: the
    public entry points raise before tracing anything."""
    import numpy as np

    from qadc_tpu.index import flat, ivf
    from qadc_tpu.quantizers.pq import ProductQuantizer
    import jax.numpy as jnp

    pq = ProductQuantizer(
        centroids=jnp.asarray(rng.normal(size=(16, 16, 2)).astype(np.float32)),
        sq_bits=4,
    )
    q = np.zeros((2, 32), np.float32)
    with pytest.raises(ValueError, match="interpret"):
        flat.search_qadc(flat.FlatIndex.create(pq), q, r=4, interpret=True)
    ix = ivf.IVFIndex.create(pq, np.zeros((4, 32), np.float32))
    with pytest.raises(ValueError, match="interpret"):
        ivf.search_qadc(ix, q, r=4, ma=2, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        ivf.search_adc(ix, q, r=4, ma=2, interpret=True)
