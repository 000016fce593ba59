"""The port on the card: tests that need a CUDA device.

Each skips without one. This file imports nothing of JAX, so it also runs
where JAX is not installed; tests/conftest.py does import JAX, so there
run it without the conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import nnstreamer_tpu_torch as pt
from nnstreamer_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2.0 ** -6),
                                       (torch.float16, 2.0 ** -9),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(1, 196, 12, 64), (2, 1000, 4, 128),
                                   (1, 7, 2, 8), (3, 33, 5, 72),
                                   (64, 196, 12, 64), (1, 1, 1, 64),
                                   (1, 65, 2, 64), (1, 50, 3, 20)])
def test_kernel_matches_plain(card, shape, dtype, tol):
    """The CUDA kernel against attention_plain on the card. bf16: two bf16
    ulps below 2 in magnitude (the plain version rounds the normalised p
    before p.v, the tensor-core kernel the unnormalised p of each key
    tile); f16 likewise with 3 more bits; f32: summation order only.
    S=1 and S=65 (one key past a 64-key tile) take the masked tail;
    D=20 (40-byte rows) takes element staging."""
    rng = np.random.default_rng(7)
    q, k, v = [torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(3)]
    before = attention.launches
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.attention_plain(q, k, v)
    assert got.dtype == dtype and got.shape == shape
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("view,staging", [("fused", "vec16"),
                                          ("offset1", "element")])
def test_kernel_reads_strided_inputs(card, view, staging):
    """q/k/v as views of one fused [B, S, 3, H, D] projection: read
    through their strides, no copies. ``offset1`` shifts the projection's
    storage by one element, so no row is 16-byte aligned and the kernel
    stages with element loads."""
    shape = (2, 50, 3, 4, 32)
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, device="cuda").bfloat16()
    qkv = (flat[:n] if view == "fused" else flat[1:]).view(shape)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    assert attention.plan(q, k, v) == ("tensor_core", staging)
    got = attention.fused_attention(q, k, v)
    want = attention.attention_plain(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -6


def test_mask_launches_nothing(card):
    q = torch.randn(1, 16, 2, 8, device="cuda")
    mask = torch.ones(1, 2, 16, 16, dtype=torch.bool, device="cuda").tril()
    before = attention.launches
    got = attention.fused_attention(q, q, q, mask=mask)
    assert attention.launches == before
    want = attention.dot_product_attention(q, q, q, mask=mask)
    assert torch.equal(got, want)


@pytest.mark.parametrize("unique", [False, True])
def test_tensortestsrc_device_pool(card, unique):
    """device=true cycles a pool of frames on the card; unique=true adds
    the frame counter (mod 199, plus 1) on the card, as the JAX package
    does."""
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=4,framerate=0/1")
    line = (f"tensortestsrc caps={caps} pattern=random seed=2 pool-size=2 "
            f"unique={str(unique).lower()} num-buffers=3 "
            "device={} ! appsink name=out")
    host = pt.parse_launch(line.format("false")).run(timeout=30)
    dev = pt.parse_launch(line.format("true")).run(timeout=30)
    pool = [b.chunks[0].host() for b in host["out"].buffers[:2]]
    for i, b in enumerate(dev["out"].buffers):
        assert b.chunks[0].is_device
        want = pool[i % 2] + np.uint8(i % 199 + 1) if unique else pool[i % 2]
        assert b.chunks[0].host().tobytes() == want.tobytes()


def test_small_vit_line_on_card(card):
    """A small ViT line on the card launches the kernel once per encoder
    block and frame, and its logits equal the CPU run's within the bf16
    bound of tests/test_torch_vit.py (3e-2)."""
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:64:64,framerate=0/1")
    model = ('"zoo://vit?size=64&d_model=64&layers=4&heads=4&classes=10'
             '&attn=pallas"')
    line = (f"tensortestsrc caps={caps} pattern=random num-buffers=3 "
            f"! tensor_filter framework=torch-cuda {{}} model={model} "
            "! appsink name=out")
    attention.launches = 0
    gpu = pt.parse_launch(line.format("")).run(timeout=120)
    assert attention.launches == 4 * 3
    cpu = pt.parse_launch(line.format("accelerator=true:cpu")).run(
        timeout=120)
    for g, c in zip(gpu["out"].buffers, cpu["out"].buffers):
        assert g.chunks[0].is_device
        np.testing.assert_allclose(g.chunks[0].host(), c.chunks[0].host(),
                                   rtol=0, atol=3e-2)


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("shape", [(224, 224, 3), (8,), (3, 5, 7),
                                   (64, 1024), (4, 224, 224, 3),
                                   (1_000_003,), (15,), (0,)])
def test_normalize_kernel_matches_plain_bitwise(card, shape, dtype):
    """The normalize kernel against normalize_plain on the card, bitwise:
    both do an f32 subtraction, an f32 product and one round-to-nearest
    cast. Ragged sizes take the scalar tail."""
    from nnstreamer_tpu_torch.ops import normalize
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 255, shape, np.uint8,
                                      endpoint=True)).cuda()
    before = normalize.launches
    got = normalize.fused_normalize(x, dtype=dtype)
    torch.cuda.synchronize()
    assert normalize.launches == before + (1 if x.numel() else 0)
    want = normalize.normalize_plain(x, dtype=dtype)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("offset", [1, 3, 8, 15])
def test_normalize_kernel_unaligned_and_strided(card, offset):
    """A view whose data pointer is not 16-byte aligned takes the scalar
    path; a non-contiguous view is made contiguous first. Custom
    scale/offset to f32, bitwise."""
    from nnstreamer_tpu_torch.ops import normalize
    raw = torch.randint(0, 256, (100_017,), dtype=torch.uint8,
                        device="cuda")
    x = raw[offset:]
    assert x.data_ptr() % 16 != 0
    got = normalize.fused_normalize(x, 2.0, 1.0, torch.float32)
    assert torch.equal(got, normalize.normalize_plain(x, 2.0, 1.0,
                                                      torch.float32))
    strided = raw[: 100_000].view(100, 1000)[:, ::3]
    assert not strided.is_contiguous()
    got = normalize.fused_normalize(strided)
    assert torch.equal(_bits(got), _bits(normalize.normalize_plain(strided)))


def test_normalize_kernel_refuses_non_uint8(card):
    from nnstreamer_tpu_torch.ops import normalize
    with pytest.raises(TypeError, match="uint8"):
        normalize.fused_normalize(torch.zeros(4, device="cuda"))


def test_submit_fetch_resolves_cuda_outputs_and_coalesces(card):
    """prefetch on CUDA outputs: every frame resolves to its own values,
    equal to .cpu(), and frames queued behind a slow copy batch share the
    next one (fewer RPCs than frames)."""
    from nnstreamer_tpu_torch.tensors import transfer as T
    T.fetch_stats(reset=True)
    T.set_simulated_rtt_ms(20.0)
    try:
        outs = []
        for i in range(32):
            a = torch.full((1001,), float(i), device="cuda") * 2.0
            b = torch.arange(6, device="cuda", dtype=torch.bfloat16) + i
            outs.append(((a, b), T.submit_fetch([a, b])))
        for (a, b), (pa, pb) in outs:
            assert isinstance(pa, T.PendingHost)
            np.testing.assert_array_equal(T.resolve(pa), a.cpu().numpy())
            got_b = T.resolve(pb)
            assert isinstance(got_b, torch.Tensor)
            assert got_b.dtype == torch.bfloat16
            assert torch.equal(got_b, b.cpu())
    finally:
        T.set_simulated_rtt_ms(0.0)
    stats = T.fetch_stats(reset=True)
    assert stats["frames"] == 32 and stats["arrays"] == 64
    assert stats["rpcs"] < 32 and stats["frames_per_rpc_avg"] > 1.0


def test_submit_fetch_waits_for_the_producer_stream(card):
    """The copy waits for the event recorded on the producer's stream:
    about 20 GEMMs queued on a side stream, then, with no host sync, a
    fetch of their result. A copy that ran early would read memory the
    GEMMs had not yet written."""
    from nnstreamer_tpu_torch.tensors import transfer as T
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        x = torch.ones(2048, 2048, device="cuda")
        for _ in range(20):
            x = x @ x / 2048.0  # stays all ones, exactly
        y = x.sum(dim=0)
        pending = T.submit_fetch([y])
    got = T.resolve(pending[0])
    np.testing.assert_array_equal(got, np.full(2048, 2048.0, np.float32))


def test_small_mobilenet_line_on_card(card):
    """A small MobileNet line with prefetch-host on the card against the
    same line on the CPU: outputs arrive as fetched host arrays, and the
    bf16 logits agree within 5 % of the largest |logit| (cuDNN and the
    CPU round bf16 at other points)."""
    from nnstreamer_tpu_torch.tensors.transfer import PendingHost
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:96:96,framerate=0/1")
    line = (f"tensortestsrc caps={caps} pattern=random num-buffers=4 "
            "! queue ! tensor_filter framework=torch-cuda {} "
            'model="zoo://mobilenet_v2?width=0.35&size=96" '
            "prefetch-host=true ! appsink name=out")
    gpu = pt.parse_launch(line.format("")).run(timeout=120)
    cpu = pt.parse_launch(line.format("accelerator=true:cpu")).run(
        timeout=120)
    assert len(gpu["out"].buffers) == len(cpu["out"].buffers) == 4
    for g, c in zip(gpu["out"].buffers, cpu["out"].buffers):
        assert isinstance(g.chunks[0]._data, (PendingHost, np.ndarray))
        gh, ch = g.chunks[0].host(), c.chunks[0].host()
        assert isinstance(gh, np.ndarray) and gh.shape == (1001,)
        np.testing.assert_allclose(gh, ch, rtol=0,
                                   atol=0.05 * np.abs(ch).max())


# -- slice 4: the detection models' ranks and the transform's device path --

def test_rank_and_argmax_take_the_first_on_ties_on_card(card):
    """The SSD rank (a stable descending sort) and torch.argmax keep
    lax.top_k's and jnp.argmax's tie order on the card too."""
    from nnstreamer_tpu_torch.models import detection as D
    best = torch.tensor([[1.0, 5.0, 5.0, 2.0, 5.0], [3.0] * 5],
                        device="cuda")
    assert D.rank_cells(best, 3).tolist() == [[1, 2, 4], [0, 1, 2]]
    big = torch.zeros(2, 361, device="cuda")
    big[:, 7::9] = 1.0
    assert D.rank_cells(big, 40)[:, :3].tolist() == [[7, 16, 25]] * 2
    hm = torch.zeros(1, 2, 3, 3, device="cuda")
    hm[0, 0, 1, 2] = hm[0, 0, 2, 0] = 1.0
    hm[0, 1] = 0.5
    assert D.keypoints_of(hm)[0].tolist() == [[1.0, 0.5, 1.0],
                                              [0.0, 0.0, 0.5]]


def test_transform_device_path_on_card(card):
    """tensor_transform on a CUDA chunk: the result stays on the card,
    in jnp's dtypes, within one f32 ulp of numpy for the arithmetic
    (CUDA divides by a scalar through its reciprocal), exact for the
    data movement, and saturating for float -> int casts."""
    from nnstreamer_tpu_torch.elements.transform import TORCH
    from nnstreamer_tpu_torch.pipeline.registry import make_element
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 255, (4, 6, 3), np.uint8, endpoint=True)
    cases = [("arithmetic", "typecast:float32,add:-127.5,div:127.5", u8),
             ("arithmetic", "add:1:2:3", u8), ("transpose", "1:2:0:3", u8),
             ("dimchg", "0:2", u8), ("padding", "1,2,0", u8),
             ("clamp", "10:200", u8),
             ("typecast", "uint8",
              np.array([-3.5, 0.5, 254.7, 300.0, np.nan], np.float32))]
    for mode, option, arr in cases:
        el = make_element("tensor_transform", mode=mode, option=option)
        el.start()
        out = el.transform(pt.Buffer([pt.Chunk(
            torch.from_numpy(arr).cuda())])).chunks[0]
        assert out.is_device, (mode, option)
        got = out.host()
        cpu = el._op(torch.from_numpy(arr), TORCH).numpy()
        assert got.dtype == cpu.dtype and got.shape == cpu.shape
        if got.dtype == np.float32:
            spacing = np.spacing(np.abs(cpu).astype(np.float32))
            assert (np.abs(got - cpu) <= spacing).all(), (mode, option)
        else:
            np.testing.assert_array_equal(got, cpu)
    np.testing.assert_array_equal(got, [0, 0, 254, 255, 0])


# -- slice 5: one CUDA graph per input signature, the in-flight window ----

def _backend(uri):
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    fw = TorchCudaFilter()
    fw.open(FilterProperties(framework="torch-cuda", model_files=(uri,)))
    return fw


SMALL_VIT = ("zoo://vit?size=64&d_model=64&layers=2&heads=4&classes=10"
             "&attn=pallas")


@pytest.mark.parametrize("uri,shape,dtype", [
    ("zoo://toyseg?height=16&width=16", (16, 16), np.float32),
    (SMALL_VIT, (64, 64, 3), np.uint8)])
def test_graph_replay_matches_eager(card, uri, shape, dtype):
    """The first invoke (eager warm-up, then the capture) and a replay
    equal an eager run on the same input bit for bit (cuDNN autotuning
    off, so the graph replays the eager algorithms); one executable for
    the signature, a second for a new one. ViT's 2 attention launches
    count once for the eager frame and once for each replay."""
    rng = np.random.default_rng(11)
    x = (rng.integers(0, 255, shape, dtype, endpoint=True)
         if dtype == np.uint8 else rng.standard_normal(shape).astype(dtype))
    fw = _backend(uri)
    before = attention.launches
    first, replay = fw.invoke([x])[0], fw.invoke([x])[0]
    torch.cuda.synchronize()
    launched = attention.launches - before
    with torch.inference_mode():
        eager = fw.traceable_fn()(torch.from_numpy(x).cuda())
    assert torch.equal(first, eager) and torch.equal(replay, eager)
    assert fw.compile_count == 1
    assert launched == (4 if "vit" in uri else 0)
    fw.invoke([np.stack([x, x])])
    assert fw.compile_count == 2
    fw.close()


def test_inflight_outputs_survive_later_replays_with_prefetch(card):
    """A window of 4 with prefetch-host: every frame's output is its own
    (a clone out of the graph's pool), not a later replay's, though the
    sink holds all of them and a queue lets the source run ahead."""
    caps = ("other/tensors,format=static,num_tensors=1,types=float32,"
            "dimensions=16:16,framerate=0/1")
    model = '"zoo://toyseg?height=16&width=16"'
    line = (f"tensortestsrc caps={caps} pattern=counter num-buffers=24 "
            "! queue max-size-buffers=8 ! tensor_filter name=f "
            f"framework=torch-cuda model={model} in-flight=4 "
            "prefetch-host=true ! queue ! appsink name=out")
    pipe = pt.parse_launch(line)
    pipe.start()
    assert pipe.wait_eos(120)
    report = pipe["f"].transfer_report()
    fw = pipe["f"].fw
    compiles = fw.compile_count
    fn = fw.traceable_fn()
    bufs = pipe["out"].buffers
    with torch.inference_mode():
        want = [fn(torch.full((16, 16), float(i), device="cuda")).cpu()
                for i in range(24)]
    pipe.stop()
    assert len(bufs) == 24 and compiles == 1
    assert report["window"] == 4 and report["completed"] == 24
    assert [b.pts for b in bufs] == sorted(b.pts for b in bufs)
    for i, b in enumerate(bufs):
        np.testing.assert_array_equal(b.chunks[0].host(), want[i].numpy())


def test_vit_line_counts_launches_by_replay(card):
    """In a line, the first frame runs eagerly and every later frame is
    one replay: 2 blocks x 6 frames = 12 attention launches, in-flight
    or not, with one executable."""
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:64:64,framerate=0/1")
    for k in (1, 3):
        attention.launches = 0
        pipe = pt.parse_launch(
            f"tensortestsrc caps={caps} pattern=random num-buffers=6 "
            f'! tensor_filter name=f framework=torch-cuda model="{SMALL_VIT}" '
            f"in-flight={k} ! appsink name=out")
        pipe.start()
        assert pipe.wait_eos(120)
        compiles = pipe["f"].fw.compile_count
        pipe.stop()
        assert attention.launches == 2 * 6 and compiles == 1


def test_capture_alongside_copy_stream_fetch(card):
    """A capture (thread_local mode) while another thread keeps the
    fetcher's copy stream busy: the capture succeeds and its replays
    equal eager runs; every fetch resolves to its own values."""
    import threading

    from nnstreamer_tpu_torch.tensors import transfer as T
    stop = threading.Event()
    errors, fetched = [], []

    def fetch_loop():
        i = 0
        try:
            while not stop.is_set():
                a = torch.full((1 << 20,), float(i), device="cuda")
                got = T.resolve(T.submit_fetch([a])[0])
                fetched.append(bool((got == float(i)).all()))
                i += 1
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    t = threading.Thread(target=fetch_loop, daemon=True)
    t.start()
    try:
        rng = np.random.default_rng(3)
        x = rng.integers(0, 255, (64, 64, 3), np.uint8, endpoint=True)
        for _ in range(3):
            fw = _backend(SMALL_VIT)
            outs = [fw.invoke([x])[0] for _ in range(3)]
            with torch.inference_mode():
                eager = fw.traceable_fn()(torch.from_numpy(x).cuda())
            assert all(torch.equal(o, eager) for o in outs)
            fw.close()
    finally:
        stop.set()
        t.join(30)
    assert not errors and fetched and all(fetched)


# -- slice 6: two graphs on two threads, stream shaping on the card -------

def test_two_threads_capture_and_replay_at_once(card):
    """Two backends of the same ViT on two threads, each capturing while
    the other may already replay (the process-wide capture lock, the
    thread_local capture mode, output clones from the caching allocator):
    every replay equals its eager run bitwise, and no attention launch is
    lost in the shared count (2 threads x (8 frames + the eager run) x 2
    blocks)."""
    import sys
    import threading

    rng = np.random.default_rng(12)
    xs = [rng.integers(0, 255, (64, 64, 3), np.uint8, endpoint=True)
          for _ in range(2)]
    results, errors = {}, []

    def leg(i):
        try:
            fw = _backend(SMALL_VIT)
            outs = [fw.invoke([xs[i]])[0] for _ in range(8)]
            torch.cuda.current_stream().synchronize()
            with torch.inference_mode():
                eager = fw.traceable_fn()(torch.from_numpy(xs[i]).cuda())
            results[i] = (all(torch.equal(o, eager) for o in outs),
                          fw.compile_count)
            fw.close()
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    attention.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=leg, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == {0: (True, 1), 1: (True, 1)}
    assert attention.launches == 2 * (8 + 1) * 2


def test_mux_pairs_cuda_chunks_from_two_threads(card):
    """tee into two filter legs on their own queue threads, tensor_mux
    pairing their CUDA outputs, tensor_demux splitting them again: the
    chunks stay on the card through tee, mux and demux, and the sinks'
    host copies see each leg's completed data for every frame."""
    caps = ("other/tensors,format=static,num_tensors=1,types=float32,"
            "dimensions=16:16,framerate=30/1")
    model = '"zoo://toyseg?height=16&width=16"'
    pipe = pt.parse_launch(
        "tensor_mux name=m sync-mode=slowest ! tensor_demux name=d "
        "d.src_0 ! queue ! appsink name=a d.src_1 ! queue ! appsink name=b "
        f"tensortestsrc caps={caps} pattern=counter num-buffers=12 "
        "! tee name=t "
        f"t. ! queue ! tensor_filter name=f0 framework=torch-cuda "
        f"model={model} ! m.sink_0 "
        "t. ! queue ! tensor_filter name=f1 framework=torch-cuda "
        'model="zoo://toyseg?height=16&width=16&seed=1" '
        "! tensor_if compared-value=A_VALUE "
        "operator=GE supplied-value=-1e30 ! m.sink_1")
    pipe.start()
    assert pipe.wait_eos(120)
    fns = [pipe[f].fw.traceable_fn() for f in ("f0", "f1")]
    bufs = {s: pipe[s].buffers for s in ("a", "b")}
    with torch.inference_mode():
        want = [[fn(torch.full((16, 16), float(i), device="cuda")).cpu()
                 for i in range(12)] for fn in fns]
    pipe.stop()
    for leg, sink in enumerate(("a", "b")):
        assert len(bufs[sink]) == 12
        assert all(b.chunks[0].is_device for b in bufs[sink])
        assert [b.pts for b in bufs[sink]] == sorted(b.pts for b in bufs[sink])
        for i, b in enumerate(bufs[sink]):
            np.testing.assert_array_equal(b.chunks[0].host(),
                                          want[leg][i].numpy())


def test_tensor_if_reads_one_element_on_the_card(card):
    """A_VALUE on a CUDA chunk compares the element numpy's host read
    gives, and the chunk passes on still on the card."""
    from nnstreamer_tpu_torch.tensors.buffer import Buffer, Chunk
    el = pt.make_element("tensor_if", compared_value="A_VALUE",
                         compared_value_option="2:1,0")
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    buf = Buffer([Chunk(x)])
    assert el._compared_value(buf) == float(x.cpu().numpy()[1, 2]) == 6.0


# -- the fault layer on the card: failed captures and restarts -----------

def _fail_first_captures(k):
    """A program that raises a TransientError during its first k CUDA
    graph captures (its eager warm-up runs clean)."""
    from nnstreamer_tpu_torch.fault import TransientError
    state = {"captures": 0}

    def fn(xs):
        y = xs[0] @ xs[0]
        if torch.cuda.is_current_stream_capturing():
            state["captures"] += 1
            if state["captures"] <= k:
                raise TransientError(f"capture {state['captures']} refused")
        return [y * 2.0]
    return fn


def test_retry_after_a_failed_capture(card):
    """A capture that fails leaves no stream capturing and nothing
    behind; a new executable in the same pool captures, and its replay
    equals the eager result."""
    from nnstreamer_tpu_torch.filters.executable import Executable, GraphPool
    dev = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=dev)
    fn = _fail_first_captures(2)
    pool = GraphPool()
    failures = 0
    for _ in range(3):
        exe = Executable(fn, dev, pool.handle_for(dev))
        try:
            first = exe([x])
            break
        except RuntimeError:
            failures += 1
            assert not torch.cuda.is_current_stream_capturing()
            assert exe.graph is None
    assert failures == 2 and exe.graph is not None
    again = exe([x])
    torch.cuda.synchronize()
    want = (x @ x) * 2.0
    assert torch.equal(first[0], want) and torch.equal(again[0], want)
    pool.release()


def test_failed_captures_leave_reserved_memory_flat(card):
    """40 more failing captures in one pool reserve no more memory than
    the first 8 did: each failure's blocks go back to the pool (and
    every capture runs on the one capture stream)."""
    from nnstreamer_tpu_torch.filters.executable import Executable, GraphPool
    dev = torch.device("cuda", 0)
    x = torch.randn(512, 512, device=dev)
    fn = _fail_first_captures(10 ** 6)
    pool = GraphPool()
    reserved = []
    for i in range(48):
        with pytest.raises(RuntimeError):
            Executable(fn, dev, pool.handle_for(dev))([x])
        if i in (7, 47):
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())
    pool.release()
    assert reserved[1] - reserved[0] <= 20 * 2 ** 20


def test_backend_close_beside_a_capture(card):
    """Backends opened and closed, each with a pool of its own that its
    close releases, while another thread captures graphs into a second
    pool: neither side fails, and every capture replays the eager
    result."""
    import threading
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    from nnstreamer_tpu_torch.filters.executable import Executable, GraphPool
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    dev = torch.device("cuda", 0)
    x = torch.randn(256, 256, device=dev)
    pool = GraphPool()
    errors, done = [], threading.Event()

    def capture():
        try:
            while not done.is_set():
                exe = Executable(lambda xs: [xs[0] @ xs[0]], dev,
                                 pool.handle_for(dev))
                exe([x])
                assert torch.equal(exe([x])[0], x @ x)
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    t = threading.Thread(target=capture)
    t.start()
    frame = np.zeros((96, 96, 3), np.uint8)
    try:
        for _ in range(4):
            fw = TorchCudaFilter()
            fw.open(FilterProperties(
                framework="torch-cuda",
                model_files=("zoo://mobilenet_v2?width=0.35&size=96",)))
            fw.invoke([frame])
            fw.close()
    finally:
        done.set()
        t.join()
    pool.release()
    assert errors == []


def test_filter_restarts_keep_reserved_memory_flat(card):
    """restart_element on a torch-cuda filter mid-stream: each restart
    re-opens the model and recaptures (one more compile), outputs equal
    an eager run of the same weights, and the reserved memory after the
    fifth restart is within 10 % of its value after the first: every
    backend the element opens captures into the element's one graph
    pool, which Pipeline.stop frees. The test drives the filter's chain
    on its own thread, so each restart falls between two frames."""
    from nnstreamer_tpu_torch.fault import restart_element
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.pipeline.events import CapsEvent, EosEvent
    from nnstreamer_tpu_torch.tensors.buffer import Buffer
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:96:96,framerate=0/1")
    pipe = pt.Pipeline()
    filt = pt.make_element(
        "tensor_filter", name="f", framework="torch-cuda",
        model="zoo://mobilenet_v2?width=0.35&size=96")
    sink = pt.make_element("appsink", name="out")
    pipe.add(filt, sink)
    pipe.link(filt, sink)
    pipe.start()
    frames = np.random.default_rng(0).integers(0, 255, (12, 96, 96, 3),
                                               dtype=np.uint8)

    def push(i):
        filt.chain(filt.sinkpad, Buffer.from_arrays([frames[i]], pts=i))

    filt.chain(filt.sinkpad, CapsEvent(pt.Caps(caps)))
    push(0)
    push(1)
    reserved = []
    for r in range(5):
        restart_element(filt)
        push(2 + 2 * r)
        push(3 + 2 * r)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    compiles = filt.stats["jit_recompiles"]
    filt.chain(filt.sinkpad, EosEvent())
    assert pipe.wait_eos(60)
    got = [b.chunks[0].host() for b in pipe["out"].buffers]
    pipe.stop()
    assert len(got) == 12 and compiles == 6
    apply_fn, module, _, _ = zoo.build("mobilenet_v2", width="0.35",
                                       size="96")
    module = module.cuda().eval()
    with torch.inference_mode():
        want = [apply_fn(module, torch.from_numpy(f).cuda()).cpu().numpy()
                for f in frames]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert reserved[-1] <= 1.1 * reserved[0]


def test_device_source_restart_keeps_its_frame_pool(card):
    """tensortestsrc device=true under on-error=restart: a failed read
    restarts the stream (preamble replayed) without staging a second
    pool of frames on the card, and the frames go on from where they
    stopped."""
    from nnstreamer_tpu_torch.fault import TransientError
    caps = ("other/tensors,format=static,num_tensors=1,types=float32,"
            "dimensions=64:64,framerate=0/1")
    pipe = pt.parse_launch(
        f"tensortestsrc name=src caps={caps} device=true pattern=counter "
        "num-buffers=8 pool-size=4 on-error=restart(3,30) ! "
        "appsink name=out")
    src, seen = pipe["src"], {}
    create = src.create

    def flaky():
        if src._count == 5 and "pool" not in seen:
            seen["pool"] = src._pool
            torch.cuda.synchronize()
            seen["allocated"] = torch.cuda.memory_allocated()
            raise TransientError("flaky read")
        return create()

    src.create = flaky
    pipe.start()
    assert pipe.wait_eos(60)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    bufs = pipe["out"].buffers
    pipe.stop()
    assert src.stats["restarts"] == 1 and src._pool is seen["pool"]
    assert len(bufs) == 8 and all(b.chunks[0].is_device for b in bufs)
    assert [float(b.chunks[0].host().flat[0]) for b in bufs] == \
        [float(i % 4) for i in range(8)]
    # the frames held at the sink are views of the one pool
    assert allocated == seen["allocated"]


# -- slice 9: the query server on the card ---------------------------------

def test_query_server_captures_one_graph_while_clients_stream(card):
    """A batch=4 MobileNet-v2 server (width 0.35, 96x96, prefetch-host)
    captures its first graph while three clients stream into it: the
    server's reader threads only unpack into host arrays, the stack goes
    to the card in the filter's staging, so the one capture succeeds and
    every frame is answered once, in order, with finite logits."""
    import socket
    import threading
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:96:96,framerate=0/1")
    server = pt.parse_launch(
        f"tensor_query_serversrc port={port} id={port} batch=4 "
        "! tensor_filter name=f framework=torch-cuda "
        'model="zoo://mobilenet_v2?width=0.35&size=96" prefetch-host=true '
        f"! queue max-size-buffers=32 ! tensor_query_serversink id={port}")
    server.start()
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 255, (96, 96, 3), np.uint8, endpoint=True)
              for _ in range(24)]
    got = {}

    def client(c):
        line = pt.parse_launch(
            f"appsrc name=in caps={caps} ! tensor_query_client port={port} "
            "timeout=60 max-request=8 ! appsink name=out")
        line.start()
        for i, f in enumerate(frames):
            line["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        line["in"].end_stream()
        line.wait_eos(120)
        got[c] = [(b.pts, b.chunks[0].host()) for b in line["out"].buffers]
        line.stop()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        compiles = server["f"].fw.compile_count
    finally:
        server.stop()
    assert not any(t.is_alive() for t in threads)
    assert compiles == 1
    for c in range(3):
        assert [p for p, _ in got[c]] == list(range(24))
        assert all(h.shape == (1001,) and np.isfinite(h).all()
                   for _, h in got[c])
