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


@pytest.mark.parametrize("dtype", ["uint8", "int8", "float32", "bfloat16"])
def test_unique_device_frames_do_not_wait_for_the_card(card, dtype):
    """unique=true adds the counter as a kernel argument: making a frame
    queues its add behind the card's work and returns (a tensor made of
    the counter would be a pageable copy that waits for the whole
    queue, so the stream would never run ahead of the source). The
    frames are the pool's plus the counter, wrapped to the dtype, as a
    tensor of the counter gives them."""
    import time
    caps = (f"other/tensors,format=static,num_tensors=1,types={dtype},"
            "dimensions=16,framerate=0/1")
    src = pt.parse_launch(  # pipelint: skip (a fixture)
        f"tensortestsrc name=s caps={caps} pattern=random seed=3 "
        "pool-size=2 device=true unique=true ! fakesink")["s"]
    src.negotiate_src_caps()
    first = src.create()  # stages the pool
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # about a second of the card's time
    t0 = time.perf_counter()
    bufs = [src.create() for _ in range(4)]
    queued = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert queued < 0.25, f"4 frames took {queued:.3f} s to queue"
    for i, b in enumerate([first] + bufs):
        x = src._pool[i % 2][0]
        want = x + torch.tensor(i % 199 + 1, device=x.device).to(x.dtype)
        assert torch.equal(b.chunks[0].raw, want)


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


# -- the rest of tensor_filter, the plain backends, SingleShot -------------

MN_SMALL = '"zoo://mobilenet_v2?width=0.35&size=96"'
MN_CAPS = ("other/tensors,format=static,num_tensors=1,types=uint8,"
           "dimensions=3:96:96,framerate=0/1")


def _mn_frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, 96, 96, 3),
                                                dtype=np.uint8)


def _allocated():
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def test_suspend_frees_the_weights_and_resume_recaptures(card):
    """SUSPEND on a backend with a captured graph: memory_allocated()
    falls by at least the weights' bytes; the next invoke brings them
    back, captures again (one more compile) and returns the same
    outputs bit for bit."""
    from nnstreamer_tpu_torch.filters.base import (FilterEvent,
                                                   FilterProperties)
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    fw = TorchCudaFilter()
    fw.open(FilterProperties(model_files=(MN_SMALL.strip('"'),)))
    x = _mn_frames(1)[0]
    before = [fw.invoke([x])[0] for _ in range(3)]
    weights = sum(t.numel() * t.element_size() for t in
                  list(fw._module.parameters()) + list(fw._module.buffers()))
    busy = _allocated()
    assert fw.handle_event(FilterEvent.SUSPEND)
    idle = _allocated()
    assert busy - idle >= weights
    after = [fw.invoke([x])[0] for _ in range(3)]
    assert fw.compile_count == 2
    assert all(torch.equal(a, before[0]) for a in before + after)
    fw.close()


def test_reload_swaps_weights_between_replays(card):
    """RELOAD_MODEL while frames stream on another thread: every output
    is bitwise one model's or the other's, the old one's first."""
    import threading
    from nnstreamer_tpu_torch.filters.base import (FilterEvent,
                                                   FilterProperties)
    from nnstreamer_tpu_torch.filters.torch_cuda_backend import \
        TorchCudaFilter
    uri = MN_SMALL.strip('"')
    x = _mn_frames(1)[0]
    refs = []
    for seed in ("0", "1"):
        ref = TorchCudaFilter()
        ref.open(FilterProperties(model_files=(f"{uri}&seed={seed}",)))
        refs.append(ref.invoke([x])[0].cpu())
        ref.close()
    fw = TorchCudaFilter()
    fw.open(FilterProperties(model_files=(uri,)))
    outs, stop = [], threading.Event()

    def stream():
        while not stop.is_set() or len(outs) < 8:
            outs.append(fw.invoke([x])[0].cpu())

    t = threading.Thread(target=stream)
    t.start()
    while len(outs) < 4:
        pass
    assert fw.handle_event(FilterEvent.RELOAD_MODEL,
                           {"model_files": (f"{uri}&seed=1",)})
    n = len(outs)
    while len(outs) < n + 4:
        pass
    stop.set()
    t.join(60)
    kinds = [0 if torch.equal(o, refs[0]) else 1 if torch.equal(o, refs[1])
             else -1 for o in outs]
    assert -1 not in kinds and kinds == sorted(kinds)
    assert kinds[0] == 0 and kinds[-1] == 1
    fw.close()


def test_shared_backend_graphs_outlive_one_leg(card):
    """Two filters under one key: stopping one (its pipeline's teardown
    included) leaves the shared backend's graph pool alone, so the other
    keeps replaying its graph with outputs equal to before."""
    line = (f"appsrc name=in caps={MN_CAPS} ! tensor_filter name=f "
            f"framework=torch-cuda model={MN_SMALL} "
            "shared-tensor-filter-key=mn ! appsink name=out")
    a, b = pt.parse_launch(line), pt.parse_launch(line)
    frames = _mn_frames(6)
    a.start()
    b.start()
    try:
        assert a["f"].fw is b["f"].fw
        for i, f in enumerate(frames[:3]):
            a["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
            b["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        a["in"].end_stream()
        assert a.wait_eos(60)
        a.stop()
        for i, f in enumerate(frames[3:]):
            b["in"].push_buffer(pt.Buffer.from_arrays([f], pts=3 + i))
        b["in"].end_stream()
        assert b.wait_eos(60)
        compiles = b["f"].fw.compile_count
    finally:
        a.stop()
        b.stop()
    got = [buf.chunks[0].host() for buf in b["out"].buffers]
    first = [buf.chunks[0].host() for buf in a["out"].buffers]
    assert compiles == 1 and len(got) == 6
    assert all(np.array_equal(x, y) for x, y in zip(first, got))
    solo = pt.parse_launch(line.replace(" shared-tensor-filter-key=mn", ""))
    solo.start()
    for i, f in enumerate(frames):
        solo["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
    solo["in"].end_stream()
    assert solo.wait_eos(60)
    solo.stop()
    want = [buf.chunks[0].host() for buf in solo["out"].buffers]
    assert all(np.array_equal(x, y) for x, y in zip(got, want))


def test_donate_input_leaves_upstream_cuda_input_intact(card):
    """in-flight=2 donate-input=true on frames pushed as CUDA tensors:
    outputs equal the run without donation and every pushed tensor is
    bitwise intact after its frame."""
    line = (f"appsrc name=in caps={MN_CAPS} ! tensor_filter name=f "
            f"framework=torch-cuda model={MN_SMALL} in-flight=2 {{}} "
            "! appsink name=out")
    dev = [torch.from_numpy(f).cuda() for f in _mn_frames(6)]
    kept = [d.clone() for d in dev]
    outs = {}
    for donate in ("donate-input=true", ""):
        pipe = pt.parse_launch(line.format(donate))
        pipe.start()
        for i, d in enumerate(dev):
            pipe["in"].push_buffer(pt.Buffer.from_arrays([d], pts=i))
        pipe["in"].end_stream()
        assert pipe.wait_eos(60)
        pipe.stop()
        outs[donate] = [b.chunks[0].host() for b in pipe["out"].buffers]
    torch.cuda.synchronize()
    assert all(torch.equal(d, k) for d, k in zip(dev, kept))
    assert len(outs[""]) == 6 and all(
        np.array_equal(a, b) for a, b in zip(outs["donate-input=true"],
                                             outs[""]))


def test_custom_easy_gets_host_arrays_from_card_chunks(card):
    """A numpy-only custom-easy function after a card filter receives
    host ndarrays, never CUDA tensors."""
    from nnstreamer_tpu_torch.filters import (register_custom_easy,
                                              unregister_custom_easy)
    seen = []

    def numpy_only(x):
        seen.append(type(x))
        return np.argsort(x)[-5:].astype(np.int32)

    register_custom_easy("top5_card", numpy_only)
    try:
        pipe = pt.parse_launch(
            f"tensortestsrc caps={MN_CAPS} pattern=random num-buffers=3 "
            f"device=true ! tensor_filter framework=torch-cuda "
            f"model={MN_SMALL} ! tensor_filter framework=custom-easy "
            "model=top5_card ! appsink name=out").run(timeout=120)
    finally:
        unregister_custom_easy("top5_card")
    assert seen == [np.ndarray] * 3
    assert all(b.chunks[0].shape == (5,) for b in pipe["out"].buffers)


def test_pytorch_backend_runs_on_the_card(card, tmp_path):
    """framework=pytorch loads a TorchScript file onto the card by
    default: outputs are CUDA tensors equal to the module's own eager
    run on the card."""
    from nnstreamer_tpu_torch.filters import find_filter
    from nnstreamer_tpu_torch.filters.base import FilterProperties
    net = torch.nn.Sequential(torch.nn.Linear(16, 8), torch.nn.ReLU()).cuda()
    path = str(tmp_path / "net.pt")
    torch.jit.trace(net, torch.zeros(16, device="cuda")).save(path)
    fw = find_filter("pytorch")()
    fw.open(FilterProperties(model_files=(path,)))
    x = np.random.default_rng(1).random(16).astype(np.float32)
    (out,) = fw.invoke([x])
    assert out.is_cuda
    with torch.no_grad():
        want = net(torch.from_numpy(x).cuda())
    assert torch.equal(out, want)
    fw.close()


def test_single_shot_on_the_card(card):
    """SingleShot with no accelerator runs on the card: CUDA outputs,
    one attention launch a layer a call (the first eagerly, then by
    replay), equal to the pipeline's outputs bit for bit."""
    uri = ("zoo://vit?size=64&d_model=64&layers=2&heads=4&classes=10"
           "&attn=pallas")
    frames = _mn_frames(3)[:, :64, :64]
    before = attention.launches
    with pt.SingleShot(uri) as shot:
        outs = [shot.invoke([f])[0] for f in frames]
        torch.cuda.synchronize()
    assert attention.launches - before == 2 * 3
    assert all(o.is_cuda for o in outs)
    caps = MN_CAPS.replace("3:96:96", "3:64:64")
    pipe = pt.parse_launch(
        f"appsrc name=in caps={caps} ! tensor_filter framework=torch-cuda "
        f'model="{uri}" ! appsink name=out')
    pipe.start()
    for i, f in enumerate(frames):
        pipe["in"].push_buffer(pt.Buffer.from_arrays(
            [np.ascontiguousarray(f)], pts=i))
    pipe["in"].end_stream()
    assert pipe.wait_eos(60)
    pipe.stop()
    for o, b in zip(outs, pipe["out"].buffers):
        assert np.array_equal(o.cpu().numpy(), b.chunks[0].host())


# -- numerics flags, sparse and delta ops ----------------------------------------


TF32_SCRIPT = r'''
import sys, numpy as np, torch
from nnstreamer_tpu_torch.filters import find_filter
from nnstreamer_tpu_torch.filters.base import FilterProperties
from nnstreamer_tpu_torch.tensors.info import TensorsInfo
path = sys.argv[1]
gen = torch.Generator().manual_seed(0)


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(256, 256, 1)

    def forward(self, x):
        return self.conv(x[None])[0]


net = Net().eval()
with torch.no_grad():
    for p in net.parameters():
        p.copy_(torch.randn(p.shape, generator=gen))
x = torch.randn(256, 32, 32, generator=gen)
torch.jit.trace(net, x).save(path)
with torch.no_grad():
    want = net(x)
    scale = float(want.abs().max())
    # the same conv on the card in TF32: what the check must tell apart
    torch.backends.cudnn.allow_tf32 = True
    tf32 = float((net.cuda()(x.cuda()).cpu() - want).abs().max()) / scale
    net.cpu()

def rel_err():
    fw = find_filter("pytorch")()
    fw.open(FilterProperties(model_files=(path,),
                             input_info=TensorsInfo.make("float32",
                                                         "32:32:256")))
    got = fw.invoke([x.cuda()])[0].cpu()
    fw.close()
    return float((got - want).abs().max()) / scale

before = rel_err()
cuda_fw = find_filter("torch-cuda")()
cuda_fw.open(FilterProperties(model_files=(
    "zoo://mobilenet_v2?width=0.35&size=32",)))
after = rel_err()
print(tf32, before, after, torch.backends.cudnn.allow_tf32)
'''


def test_pytorch_conv_is_full_f32_before_and_after_a_torch_cuda_open(
        card, tmp_path):
    """In a fresh process (default flags: cuDNN TF32 on, and traced
    under them), an f32 conv TorchScript model under framework=pytorch
    agrees with its CPU f32 run within 1e-5 of the largest output,
    before and after a torch-cuda open: full f32 either way. The same
    conv run in TF32 on the card misses by more than 1e-5 (10-bit
    mantissa, 256-term sums), so the bound tells the two apart. A 1x1
    conv, because cuDNN may take Winograd for a 3x3 one, whose f32 error
    is itself above 1e-5."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "tf32.py"
    script.write_text(TF32_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "conv.pt")],
        check=True, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": root})
    tf32, before, after, flag = out.stdout.split()[-4:]
    assert float(tf32) > 1e-5, out.stdout  # the bound tells TF32 apart
    assert float(before) <= 1e-5 and float(after) <= 1e-5, out.stdout
    assert flag == "False"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.uint8])
def test_sparse_pack_unpack_on_card_equal_the_cpu(card, dtype):
    from nnstreamer_tpu_torch.ops import sparse
    rng = np.random.default_rng(2)
    x = rng.standard_normal(224 * 224 * 3).astype(np.float32) * 9
    x[rng.random(x.size) > 0.05] = 0
    x[:3] = [np.nan, -0.0, np.inf]
    t = torch.from_numpy(x).to(dtype) if dtype != torch.uint8 else \
        torch.from_numpy(np.clip(np.nan_to_num(np.abs(x)), 0, 255)
                         .astype(np.uint8))
    cap = int(t.numel() * 0.1)
    sparse.reset_counts()
    got = sparse.fetch_packed(*sparse.pack(t.cuda(), cap))
    want = sparse.fetch_packed(*sparse.pack(t, cap))
    assert got[2] == want[2] <= cap
    assert got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    vals = got[1][:got[2]]
    if dtype == torch.bfloat16:
        vals = torch.from_numpy(vals.view(np.int16).copy()).view(dtype)
    dense = sparse.unpack(got[0][:got[2]], vals, t.numel(), "cuda")
    assert dense.is_cuda
    plain = torch.where(t == 0, torch.zeros_like(t), t)  # -0.0 -> +0.0
    assert dense.cpu().view(torch.uint8).numpy().tobytes() == \
        plain.view(torch.uint8).numpy().tobytes()
    assert (sparse.packs, sparse.unpacks) == (1, 1)
    assert sparse.pack_d2h_bytes == 8 + cap * (8 + t.element_size())


def test_tile_error_on_card_matches_plain(card):
    from nnstreamer_tpu_torch.ops import delta
    rng = np.random.default_rng(3)
    cur = rng.standard_normal((224, 224)).astype(np.float32) * 60
    ref = cur + rng.standard_normal((224, 224)).astype(np.float32)
    delta.runs = 0
    got = delta.tile_error(torch.from_numpy(cur).cuda(),
                           torch.from_numpy(ref).cuda(), 16).cpu().numpy()
    want = delta.tile_error_reference(cur, ref, 16)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert delta.runs == 1


def test_sparse_line_on_card_round_trips_bitwise(card):
    from nnstreamer_tpu_torch.ops import sparse
    caps = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)float32,dimensions=(string)3:64:64")
    pipe = pt.parse_launch(
        f'appsrc name=in caps="{caps}" ! tensor_sparse_enc density=0.1 '
        '! tensor_sparse_dec device=true ! appsink name=out')
    rng = np.random.default_rng(4)
    frames = []
    for _ in range(4):
        x = rng.standard_normal((64, 64, 3)).astype(np.float32)
        x[rng.random(x.shape) > 0.05] = 0
        frames.append(torch.from_numpy(x).cuda())
    sparse.reset_counts()
    pipe.start()
    for f in frames:
        pipe["in"].push_buffer(pt.Buffer.from_arrays([f]))
    pipe["in"].end_stream()
    assert pipe.wait_eos(60)
    pipe.stop()
    got = [b.chunks[0].raw for b in pipe["out"].buffers]
    assert all(g.is_cuda for g in got)
    assert all(torch.equal(g.view(torch.int32), f.view(torch.int32))
               for g, f in zip(got, frames))
    assert sparse.packs == sparse.unpacks == 4


def test_delta_gate_on_card_equals_host(card):
    caps = ("other/tensors,format=static,num_tensors=1,"
            "types=(string)uint8,dimensions=(string)3:64:64")
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (64, 64, 3), np.uint8)
    frames = []
    for i in range(12):
        f = base.copy()
        if i % 3 == 0:
            f[(i * 4) % 48:(i * 4) % 48 + 16, 8:24] = rng.integers(
                0, 255, (16, 16, 3), np.uint8)
            base = f
        frames.append(f)
    skipped = []
    for device in ("true", "false"):
        pipe = pt.parse_launch(
            f'appsrc name=in caps="{caps}" ! tensor_delta name=d mode=gate '
            f'device={device} tile=16 ! appsink name=out')
        pipe.start()
        for i, f in enumerate(frames):
            pipe["in"].push_buffer(pt.Buffer.from_arrays(
                [torch.from_numpy(f).cuda()], pts=i))
        pipe["in"].end_stream()
        assert pipe.wait_eos(60)
        pipe.stop()
        skipped.append([b.pts for b in pipe["out"].buffers])
    assert skipped[0] == skipped[1] and len(skipped[0]) < len(frames)


# -- the generative line (slice 12) --------------------------------------------

BF16_SCRIPT = r'''
import torch
from nnstreamer_tpu_torch.filters import find_filter
from nnstreamer_tpu_torch.filters.base import FilterProperties
gen = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(8, 6144, generator=gen, device="cuda").bfloat16()
w = torch.randn(6144, 1536, generator=gen, device="cuda").bfloat16()
reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def opened(framework, model):
    fw = find_filter(framework)()
    fw.open(FilterProperties(model_files=(model,)))
    return fw


a = opened("torch-cuda", "zoo://mlp")
before = x @ w
b = opened("llm", "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2")
after = x @ w
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
in_bf16 = x @ w
torch.cuda.synchronize()
print(reduced, torch.equal(before, after), torch.equal(before, in_bf16),
      torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
'''


def test_bf16_gemm_equal_before_and_after_an_llm_open(card, tmp_path):
    """In a fresh process (bf16 reduction of split-K sums allowed by
    default), a bf16 GEMM with K = 6144 (an MLP down-projection's depth)
    gives the same bits after a torch-cuda open and after an llm open:
    each open turns the reduction off, so no result depends on which
    filter opened first."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "bf16.py"
    script.write_text(BF16_SCRIPT)
    out = subprocess.run(
        [sys.executable, str(script)], check=True, capture_output=True,
        text=True, timeout=300, env={**os.environ, "PYTHONPATH": root})
    default, equal, same_as_bf16, _ = out.stdout.split()[-4:]
    assert default == "True"       # the flag the opens turn off
    assert equal == "True", out.stdout
    print("bf16 GEMM, f32 sums vs bf16 sums bitwise:", same_as_bf16)


LLM_ZOO = "zoo://gpt?vocab=64&d_model=32&n_heads=4&n_layers=2"


def _llm_tokens(custom, prompts, n):
    import threading
    fw = pt.filters.find_filter("llm")()
    fw.open(pt.filters.FilterProperties(model_files=(LLM_ZOO,),
                                        custom_properties=custom))
    got, done = {}, threading.Event()

    def dispatch(outs, ctx):
        got.setdefault(ctx, []).append(int(np.asarray(outs[0]).ravel()[0]))
        if sum(map(len, got.values())) == n * len(prompts):
            done.set()

    fw.set_async_dispatcher(dispatch)
    for i, p in enumerate(prompts):
        fw.invoke_async([p], ctx=i)
    assert done.wait(120)
    return fw, [got[i] for i in range(len(prompts))]


LLM_PROMPTS = [np.arange(1, 6, dtype=np.int32), np.array([7, 8], np.int32),
               np.arange(20, 40, dtype=np.int32)]


def test_llm_paged_chunked_and_graphs_on_the_card(card):
    """On the card, with the decode state in captured graphs: paged
    equals contiguous, chunk 4 equals per-token, a replay of the step
    graph equals decode_step_multi run eagerly on a copy of its state,
    and the tokens are CPU-side host arrays, one fetch a chunk."""
    from nnstreamer_tpu_torch.models import transformer as tfm
    base = "max_tokens:10,n_parallel:3,max_len:64"
    fw, ref = _llm_tokens(base + ",chunk:4", LLM_PROMPTS, 10)
    assert fw.compile_count >= 2   # the prefill pass and a chunk
    fw.close()
    fw, paged = _llm_tokens(base + ",chunk:4,paged:true,block_size:8,"
                            "pool_blocks:24", LLM_PROMPTS, 10)
    fw.close()
    fw, per_token = _llm_tokens(base, LLM_PROMPTS, 10)
    be = fw._backend
    with torch.no_grad():
        be.active.fill_(True)
        cache = {k: v.clone() for k, v in be.cache.items()}
        eager, _ = tfm.decode_step_multi(fw._params, cache, be.tok.clone(),
                                         be.active.clone(), fw._cfg)
        be._graphs["step"].replay()
        torch.cuda.synchronize()
    assert torch.equal(eager, be.logits)
    fw.close()
    assert paged == ref and per_token == ref


def test_llm_prefix_cache_exact_on_the_card(card):
    """A prompt prefilled over cached blocks gives the tokens of its
    whole prefill, bit for bit, on the card."""
    pref = np.arange(1, 25, dtype=np.int32)
    prompts = [np.concatenate([pref, [30, 31]]).astype(np.int32),
               np.concatenate([pref, [40, 41, 42]]).astype(np.int32)]
    base = "max_tokens:8,n_parallel:2,max_len:64,block_size:8,paged:true"
    fw, off = _llm_tokens(base + ",prefix_cache:false", prompts, 8)
    fw.close()
    fw, on = _llm_tokens(base + ",prefix_cache:true", prompts, 8)
    assert fw.stats["prefill_cached_tokens"] == 24
    fw.close()
    assert on == off


def test_llm_refuses_out_of_vocab_ids_before_a_launch(card):
    """An id past the vocabulary is refused on the host: the card's
    context stays usable (an out-of-range embedding read would be a
    device-side assert)."""
    fw = pt.filters.find_filter("llm")()
    fw.open(pt.filters.FilterProperties(model_files=(LLM_ZOO,),
                                        custom_properties="max_tokens:2"))
    with pytest.raises(ValueError, match="vocabulary"):
        fw.invoke([np.array([1, 64], np.int32)])
    assert fw.invoke([np.array([1, 63], np.int32)])[0].shape == (2,)
    fw.close()


# -- the serving stack ------------------------------------------------------

def _serve_line(ident, buckets, extra=""):
    """tensor_serve_src ! the small MobileNet-v2 (prefetch-host) ! queue !
    tensor_serve_sink, started; returns (pipeline, port)."""
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    server = pt.parse_launch(
        f"tensor_serve_src name=src port={port} id={ident} "
        f"buckets={buckets} max-wait-ms=4 max-queue=64 "
        f"! tensor_filter name=f framework=torch-cuda model={MN_SMALL} "
        f"prefetch-host=true {extra}! queue max-size-buffers=32 "
        f"! tensor_serve_sink id={ident}")
    server.start()
    return server, port


def _serve_clients(port, frames, n_clients, gap_s=0.0):
    """``n_clients`` query clients, each sending every frame (pts = frame
    index) and waiting for EOS; returns {client: [(pts, host logits)]}."""
    import threading
    import time
    got = {}

    def client(c):
        line = pt.parse_launch(
            f"appsrc name=in caps={MN_CAPS} ! tensor_query_client "
            f"port={port} timeout=60 max-request=16 ! appsink name=out")
        line.start()
        for i, f in enumerate(frames):
            line["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
            if gap_s:
                time.sleep(gap_s * (c + 1))
        line["in"].end_stream()
        line.wait_eos(120)
        got[c] = [(b.pts, b.chunks[0].host()) for b in line["out"].buffers]
        line.stop()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    return got


def test_serve_filter_captures_at_most_one_graph_a_bucket(card):
    """Ragged concurrency (clients pacing apart) over buckets 1, 2, 4, 8:
    the serve filter makes at most one executable, one captured graph, a
    bucket, and every frame is answered once, in order."""
    server, port = _serve_line(90, "1,2,4,8")
    try:
        got = _serve_clients(port, list(_mn_frames(16)), 6, gap_s=0.002)
        fw = server["f"].fw
        compiles, sigs = fw.compile_count, len(fw._executables)
        rep = server["src"].scheduler.report()
    finally:
        server.stop()
    assert 1 <= compiles == sigs <= 4
    assert rep["completed"] == 96
    for c in range(6):
        assert [p for p, _ in got[c]] == list(range(16))


def test_serve_padded_rows_never_reach_the_demux(card):
    """Three lone requests in bucket 8: the card's output has 8 rows (5
    padded), the demux answers 3, each reply equal to its frame's
    batch-1 logits within the batched-convolution bound."""
    frames = list(_mn_frames(3, seed=4))
    local = pt.parse_launch(f"appsrc name=in caps={MN_CAPS} ! tensor_filter "
                            f"framework=torch-cuda model={MN_SMALL} "
                            "! appsink name=out")
    local.start()
    for i, f in enumerate(frames):
        local["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
    local["in"].end_stream()
    local.wait_eos(120)
    want = [b.chunks[0].host() for b in local["out"].buffers]
    local.stop()
    server, port = _serve_line(91, "8", extra="")
    sched = server["src"].scheduler
    seen = []
    complete = sched.complete

    def spy(batch, outputs):
        seen.append((len(batch), [tuple(o.shape) for o in outputs]))
        complete(batch, outputs)

    sched.complete = spy
    try:
        got = {}
        for i, f in enumerate(frames):
            got[i] = _serve_clients(port, [f], 1)[0]
    finally:
        server.stop()
    assert seen == [(1, [(8, 1001)])] * 3
    for i in range(3):
        (pts, logits), = got[i]
        assert pts == 0
        scale = float(np.abs(want[i]).max())
        assert float(np.abs(logits - want[i]).max()) <= 1e-4 * scale


def test_serve_sink_reads_one_copy_a_batch(card):
    """prefetch-host=true: each batch's logits leave the card in one copy
    (fetch_stats: arrays = batches), and the sink waits on that fetch
    instead of starting another."""
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats
    server, port = _serve_line(92, "1,2,4,8")
    fetch_stats(reset=True)
    try:
        _serve_clients(port, list(_mn_frames(12)), 4)
        batches = server["src"].scheduler.report()["batches"]
        invokes = server["f"].stats["buffers"]
    finally:
        server.stop()
    fetch = fetch_stats(reset=True)
    assert batches == invokes
    assert fetch["arrays"] == batches
    assert fetch["frames"] == batches


def test_serve_drain_after_suspend_and_resume_answers_every_request(card):
    """suspend=100: a burst, an idle gap that unloads the model, a second
    burst that brings it back (one more capture), then Pipeline.drain()
    mid-stream: drain returns True and every request is answered once
    (RESULT or SHED)."""
    import time
    server, port = _serve_line(93, "1,2,4,8", extra="suspend=100 ")
    frames = list(_mn_frames(8))
    try:
        _serve_clients(port, frames, 2)
        fw = server["f"].fw
        deadline = time.monotonic() + 10      # idle: the model suspends
        while fw._module is not None and time.monotonic() < deadline:
            time.sleep(0.01)
        suspended = fw._module is None
        c0 = fw.compile_count
        line = pt.parse_launch(
            f"appsrc name=in caps={MN_CAPS} ! tensor_query_client name=qc "
            f"port={port} timeout=60 max-request=32 ! appsink name=out")
        line.start()
        for i in range(32):
            line["in"].push_buffer(pt.Buffer.from_arrays(
                [frames[i % 8]], pts=i))
        deadline = time.monotonic() + 60
        while not line["out"].buffers and time.monotonic() < deadline:
            time.sleep(0.005)
        ok = server.drain(deadline=60)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with line["qc"]._plock:
                owed = len(line["qc"]._pending)
            if not owed and (len(line["out"].buffers)
                             + line["qc"].stats["shed"]) >= 32:
                break
            time.sleep(0.01)
        n_result = len(line["out"].buffers)
        n_shed = line["qc"].stats["shed"]
        rep = server["src"].scheduler.report()
        c1 = fw.compile_count
        line["in"].end_stream()
        line.stop()
    finally:
        server.stop()
    assert suspended and c1 > c0              # resumed: captured afresh
    assert ok is True
    assert n_result + n_shed == 32 and n_result > 0
    assert rep["requests"] == rep["completed"] + rep["shed_deadline"] \
        + rep["cancelled"] + rep["shed_failed"]


# -- training and the checkpoint layer on the card ----------------------------

TINY_VIT = "size=32&patch=8&d_model=32&layers=2&heads=2&classes=4"


def _vit_dataset(tmp_path, n=12):
    """n seeded 32x32x3 uint8 frames with int32 labels as a datarepo
    file and its JSON index."""
    import json
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 4, (n, 1)).astype(np.int32)
    data = tmp_path / "vit.data"
    with open(data, "wb") as f:
        for x, y in zip(frames, labels):
            f.write(x.tobytes() + y.tobytes())
    jpath = tmp_path / "vit.json"
    jpath.write_text(json.dumps({
        "gst_caps": ("other/tensors, format=(string)static, "
                     "framerate=(fraction)0/1, num_tensors=(int)2, "
                     "dimensions=(string)3:32:32.1, "
                     "types=(string)uint8.int32"),
        "total_samples": n, "sample_size": 32 * 32 * 3 + 4}))
    return data, jpath, frames, labels


def _vit_train_line(data, jpath, src_epochs, epochs, extra=""):
    return (f"datareposrc location={data} json={jpath} is-shuffle=false "
            f"epochs={src_epochs} ! tensor_trainer name=t "
            f'framework=torch-cuda model-config="zoo://vit?{TINY_VIT}'
            f'&lr=1e-2" num-training-samples=8 num-validation-samples=4 '
            f"epochs={epochs} {extra} ! appsink name=out")


def test_vit_trainer_steps_on_the_card(card, tmp_path):
    """datareposrc ! tensor_trainer on cuda:0 by default: the weights
    live on the card, the epoch-1 loss is the seed-0 model's
    cross-entropy on the first batch (same card, same kernels: 1e-6
    relative), and the loss falls."""
    from nnstreamer_tpu_torch.models import zoo
    data, jpath, frames, labels = _vit_dataset(tmp_path)
    pipe = pt.parse_launch(_vit_train_line(data, jpath, 4, 4))
    pipe.start()
    try:
        assert pipe.wait_eos(120)
        devices = {str(p.device) for p in pipe["t"].fw.module.parameters()}
    finally:
        pipe.stop()
    losses = [float(b.chunks[0].host()[0]) for b in pipe["out"].buffers]
    kw = dict(p.split("=") for p in TINY_VIT.split("&"))
    apply_fn, m, _, _ = zoo.build("vit", **kw)
    with torch.no_grad():
        logp = torch.log_softmax(apply_fn(m.cuda(), torch.from_numpy(
            frames[:8]).cuda()).float(), -1)
        want = float(-logp.gather(
            -1, torch.from_numpy(labels[:8]).cuda().long()).mean())
    assert devices == {"cuda:0"}
    assert abs(losses[0] - want) <= 1e-6 * abs(want)
    assert losses[3] < losses[0]


def test_trainer_snapshot_restore_on_the_card(card, tmp_path):
    """Preempt after epoch 2, restore into a 4-epoch line: epochs 3-4
    continue the straight run (its losses within 1e-4 relative; the
    moments come back from the snapshot onto the card)."""
    data, jpath, _, _ = _vit_dataset(tmp_path)
    straight = pt.parse_launch(_vit_train_line(data, jpath, 4, 4))
    straight.run(timeout=120)
    want = {int(b.pts): float(b.chunks[0].host()[0])
            for b in straight["out"].buffers}
    ckpt = str(tmp_path / "ckpt")
    first = pt.parse_launch(_vit_train_line(data, jpath, 2, 2))
    first.start()
    assert first.wait_eos(120)
    report = first.preempt(5.0, ckpt)
    assert report["drained"] is True
    resumed = pt.parse_launch(_vit_train_line(data, jpath, 2, 4))
    resumed.restore(ckpt)
    resumed.start()
    try:
        assert resumed.wait_eos(120)
        opt = resumed["t"].fw.optimizer
        moments = [s["exp_avg"].device.type for s in opt.state.values()]
    finally:
        resumed.stop()
    got = [(int(b.pts), float(b.chunks[0].host()[0]))
           for b in resumed["out"].buffers]
    assert [e for e, _ in got] == [3, 4, 4]
    assert moments and set(moments) == {"cuda"}
    for e, loss in got:
        assert abs(loss - want[e]) <= 1e-4 * abs(want[e])


def test_params_dir_serves_trained_weights_through_the_kernel(card,
                                                              tmp_path):
    """zoo://vit?attn=pallas&params_dir=: the saved weights (seed 1's,
    not the seed-0 init) served through the attention kernel, one launch
    a layer a frame, against the same weights' eager forward with stock
    attention (the ViT lines' bf16 rule)."""
    from nnstreamer_tpu_torch.models import zoo
    from nnstreamer_tpu_torch.trainers import save_params
    kw = dict(p.split("=") for p in TINY_VIT.split("&"))
    apply_fn, trained, _, _ = zoo.build("vit", seed="1", **kw)
    save_params(str(tmp_path / "ckpt"), trained)
    frames = np.random.default_rng(3).integers(
        0, 256, (4, 32, 32, 3), dtype=np.uint8)
    caps = ("other/tensors,format=static,num_tensors=1,types=uint8,"
            "dimensions=3:32:32,framerate=0/1")
    pipe = pt.parse_launch(
        f"appsrc name=in caps={caps} ! tensor_filter framework=torch-cuda "
        f'model="zoo://vit?{TINY_VIT}&attn=pallas&params_dir='
        f'{tmp_path / "ckpt"}" ! appsink name=out')
    before = attention.launches
    pipe.start()
    for i, f in enumerate(frames):
        pipe["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
    pipe["in"].end_stream()
    pipe.wait_eos(60)
    pipe.stop()
    got = torch.from_numpy(np.stack(
        [b.chunks[0].host() for b in pipe["out"].buffers]))
    assert attention.launches - before == 2 * len(frames)
    with torch.no_grad():
        want = apply_fn(trained.cuda(), torch.from_numpy(frames).cuda()).cpu()
        _, seed0, _, _ = zoo.build("vit", **kw)
        init = apply_fn(seed0.cuda(), torch.from_numpy(frames).cuda()).cpu()
    tol = 5e-2 + 0.05 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    assert (init - want).abs().max().item() > tol


def _llm_split(custom, prompts, n):
    """A prefill replica shipping ``prompts`` to a decode replica over
    loopback, both on the card: -> (prefill, decode, {sid: tokens}); the
    caller closes both."""
    import threading
    mk = pt.filters.find_filter("llm")
    dec = mk()
    dec.open(pt.filters.FilterProperties(
        model_files=(LLM_ZOO,), custom_properties=custom +
        ",n_parallel:3,role:decode,handoff_port:0,block_size:8,"
        "pool_blocks:24"))
    got, done = {}, threading.Event()

    def dispatch(outs, ctx):
        got.setdefault(ctx, []).append(int(np.asarray(outs[0]).ravel()[0]))
        if sum(map(len, got.values())) == n * len(prompts):
            done.set()

    dec.set_async_dispatcher(dispatch)
    pre = mk()
    pre.open(pt.filters.FilterProperties(
        model_files=(LLM_ZOO,), custom_properties=custom +
        f",role:prefill,handoff:127.0.0.1:{dec.handoff_port}"))
    for p in prompts:
        pre.invoke_async([p])
    assert done.wait(120)
    return pre, dec, got


@pytest.mark.parametrize("precision", ["none", "bf16"])
def test_llm_handoff_lands_bit_equal_in_the_arena(card, precision):
    """The prefill replica's K/V of a prompt, gathered back from the
    decode replica's block arena, equal the prefill pass's bitwise under
    kv_precision none and bf16 (bf16 K/V are never downcast)."""
    from nnstreamer_tpu_torch.filters import llm as L
    from nnstreamer_tpu_torch.models import transformer as tfm
    prompt = LLM_PROMPTS[2]
    captured = {}
    real = L._Backend.seat

    def seat(self, slot, plen, logits, seed, drawn=0):
        if isinstance(self, L._PagedBackend):
            blocks = torch.tensor(self.blocks[slot], device="cuda")
            k, v = tfm.pool_gather(self.pool, blocks)
            captured["kv"] = (k[:, :plen].clone(), v[:, :plen].clone())
        return real(self, slot, plen, logits, seed, drawn)

    L._Backend.seat = seat
    try:
        pre, dec, _ = _llm_split(f"max_tokens:4,max_len:64,"
                                 f"kv_precision:{precision}", [prompt], 4)
    finally:
        L._Backend.seat = real
    try:
        _, k, v = pre._prefill(64)(prompt)
        n = prompt.size
        assert torch.equal(captured["kv"][0], k[:, :n])
        assert torch.equal(captured["kv"][1], v[:, :n])
        assert dec.stats["kv_shipped_tokens"] == n
    finally:
        pre.close()
        dec.close()


def test_llm_prefill_kv_leaves_the_card_in_one_copy(card):
    """A prefill replica's K/V and logits leave the card in one copy
    batch a stream (one fetch RPC), not one copy a layer."""
    from nnstreamer_tpu_torch.tensors.transfer import fetch_stats
    fetch_stats(reset=True)
    pre, dec, _ = _llm_split("max_tokens:1,max_len:64", [LLM_PROMPTS[0]], 1)
    try:
        assert pre.stats["kv_handoffs_out"] == 1
        # two fetches in all: the handoff's three tensors, and the decode
        # replica's one token (max_tokens:1 runs no decode step)
        assert dec.stats["decode_dispatches"] == 0
        assert fetch_stats()["rpcs"] == 2
    finally:
        pre.close()
        dec.close()


def test_llm_split_equals_monolithic_on_the_card(card):
    """The split's greedy tokens equal a monolithic paged run's on the
    card, and the decode replica computed no prompt token."""
    from nnstreamer_tpu_torch.checkpoint.state import token_sha
    base = "max_tokens:10,max_len:64"
    fw, mono = _llm_tokens(base + ",n_parallel:3,paged:true,block_size:8,"
                           "pool_blocks:24", LLM_PROMPTS, 10)
    fw.close()
    pre, dec, got = _llm_split(base, LLM_PROMPTS, 10)
    try:
        assert got == {token_sha(p): mono[i]
                       for i, p in enumerate(LLM_PROMPTS)}
        assert dec.stats["prefill_computed_tokens"] == 0
        assert pre.stats["kv_handoff_errors"] == 0
    finally:
        pre.close()
        dec.close()


# -- the telemetry plane and the fleet --------------------------------------

def test_scrape_on_the_card_line(card, tmp_path, monkeypatch):
    """The small MobileNet-v2 line on the card behind a MetricsServer:
    the scraped e2e count equals the frames at the sink, every element
    has its counters, and each frame's span tree is connected (spans
    read host clocks only)."""
    from nnstreamer_tpu_torch.obs import context as obs_ctx
    from nnstreamer_tpu_torch.obs import metrics, spans
    from nnstreamer_tpu_torch.obs.server import MetricsServer, scrape
    monkeypatch.setenv("NNS_TPU_FLIGHT_DIR", str(tmp_path))
    metrics.reset()
    srv = MetricsServer(port=0).start()
    p = pt.parse_launch(
        f"appsrc name=in caps={MN_CAPS} ! queue name=q "
        f"! tensor_filter name=f framework=torch-cuda model={MN_SMALL} "
        "! appsink name=out")
    p.start()
    try:
        for i, f in enumerate(_mn_frames(8)):
            p["in"].push_buffer(pt.Buffer.from_arrays([f], pts=i))
        p["in"].end_stream()
        assert p.wait_eos(120)
        samples = metrics.parse(scrape("localhost", srv.bound_port))
    finally:
        p.stop()
        srv.stop()
    assert samples[("nns_e2e_latency_seconds_count",
                    (("pipeline", p.name), ("sink", "out")))] == 8.0
    for name in ("q", "f", "out"):
        assert samples[("nns_element_counter_total",
                        (("counter", "buffers"), ("element", name),
                         ("pipeline", p.name)))] == 8.0
    traces = {obs_ctx.ctx_of(b).trace_id for b in p["out"].buffers}
    assert len(traces) == 8
    got = {}
    for _tid, s in spans.snapshot():
        if s[4] in traces:
            got.setdefault(s[4], []).append(s)
    for t in traces:
        ids = {s[5] for s in got[t]}
        assert [s[6] for s in got[t]].count(0) == 1
        assert all(s[6] == 0 or s[6] in ids for s in got[t])
        assert {"in", "q", "f", "out"} <= {s[0] for s in got[t]}


def test_warm_replica_captures_before_replica_ready(card, tmp_path):
    """A replica of the small MobileNet-v2 serve line with the compile
    cache: one life seeds it; the next captures its bucket's graph at
    open — before it prints replica-ready — and its frames capture
    nothing more."""
    from nnstreamer_tpu_torch.fleet import ReplicaProcess, ReplicaSpec
    prelude = (
        "import nnstreamer_tpu_torch.filters.torch_cuda_backend as _b\n"
        "_open, _invoke = _b.TorchCudaFilter.open, _b.TorchCudaFilter.invoke\n"
        "def _opened(self, props):\n"
        "    _open(self, props)\n"
        "    self._serving = True\n"
        "    print(f'backend-open prewarmed={self.prewarmed} '\n"
        "          f'compiles={self.compile_count}', flush=True)\n"
        "def _invoked(self, inputs):\n"
        "    n = self.compile_count\n"
        "    out = _invoke(self, inputs)\n"
        "    if getattr(self, '_serving', False) and self.compile_count != n:\n"
        "        print('backend-frame-capture', flush=True)\n"
        "    return out\n"
        "_b.TorchCudaFilter.open = _opened\n"
        "_b.TorchCudaFilter.invoke = _invoked\n")
    desc = ("tensor_serve_src name=src port={port} id=97 buckets=1 "
            "max-wait-ms=2 ! tensor_filter name=f framework=torch-cuda "
            f"model={MN_SMALL} ! tensor_serve_sink id=97")
    spec = ReplicaSpec(desc_template=desc, ckpt_root=str(tmp_path / "ck"),
                       compile_cache=str(tmp_path / "cc"), prelude=prelude)
    lines = []
    for life in ("seed", "warm"):
        rp = ReplicaProcess(spec, life)
        rp.spawn()
        try:
            port = rp.wait_ready(timeout=180)
            got = _serve_clients(port, list(_mn_frames(2)), 1)
            assert [pts for pts, _ in got[0]] == [0, 1]
            rp.preempt(timeout=60)
        finally:
            rp.kill()
        lines.append(rp.tail(400).splitlines())
    seed, warm = lines
    assert "backend-open prewarmed=0 compiles=0" in seed
    assert "backend-frame-capture" in seed
    assert "backend-frame-capture" not in warm
    opened = warm.index("backend-open prewarmed=1 compiles=1")
    ready = next(i for i, ln in enumerate(warm)
                 if ln.startswith("replica-ready "))
    assert opened < ready
