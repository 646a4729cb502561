#!/usr/bin/env python3
"""On-card smoke test of the grl_torch port (PyTorch + CUDA, NVIDIA H100).

Run from the root of a checkout, with one GPU visible::

    python3 chip_smoke.py

Phases, printed as they run. Any failure raises and exits non-zero
before the result line is printed; no phase's failure is passed over.

1. ``env``: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, TF32 off, and the build of every CUDA source under
   ``grl_torch/csrc`` for ``sm_90a`` (one ``nvcc`` per source, all
   started together).
2. ``kernel``: K3 (``grl_torch/csrc/relagg.cu``) against its plain
   PyTorch version on the card, B=8, L=6, N in {64, 192, 256}, F in
   {256, 512}, float32 and bfloat16. Each case is timed with CUDA events
   (median of single launches, L2 flushed before each) beside the plain
   version, the one PyTorch call that computes the same function
   (``library_ms``), and the card's bound.
3. ``serve``: the main path, ``GNNLearningWarper.predict`` ->
   ``KVInference`` -> ``GraphCNNDropEdge`` at the full sumi width
   (input_dim 4369, output_dim 53, 6 relations, net_size 256,
   ``kernel_impl: pallas``, bfloat16), batch 8, bucket 256, with random
   weights drawn from a seed. Prints pages/s and boxes/s, checks the K3
   launch count, and holds the predictions against the plain
   (``kernel_impl: xla``) path with the same weights, in bfloat16 and in
   float32.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: HBM3
# bandwidth, bf16 tensor-core rate, float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B, L = 8, 6
KERNEL_NS = (64, 192, 256)
KERNEL_FS = (256, 512)
# Nonzero share of the heuristic graph's (N, 6, N) adjacency on the
# synthetic 230-box pages the serve phase sends (about 0.5 neighbours per
# node and relation); one denser case per dtype exercises long sums.
SPARSE_DENSITY = 0.002
DENSE_DENSITY = 0.5
# f32: both sides accumulate in float32, in a different order (~1e-6).
# bf16: both accumulate in float32 and round once to bfloat16, so they
# differ by at most one bfloat16 rounding of the output (2**-7 relative).
# The absolute term covers sums that cancel to near zero.
RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
ATOL_OF_MAX = 1e-5

PAGES = 64
SERVE_REPEATS = 3
NUM_CLASSES = 26  # output_dim = 26 * 2 key types + 1 = 53
CHARSET_SIZE = 4365  # input_dim = 4365 + 4 bbox features = 4369
NET_SIZE = 256
# Agreement of the kernel path with the plain path on the same weights.
# float32: the two differ only in summation order inside K3 (~1e-6), so
# nearly every box keeps its class. bfloat16: K3 and torch.matmul round
# their bf16 outputs at different places in the sum's last bit, and the
# difference grows through three GraphConvs, the attention and the
# 1280-wide RanPAC head; a box whose two best logits are that close can
# swap class.
SERVE_AGREEMENT = {"float32": (0.999, 1e-4), "bfloat16": (0.99, 2e-2)}


def log(message: str) -> None:
    print(message, flush=True)


def require(condition: bool, message: str) -> None:
    if not condition:
        raise AssertionError(message)


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------
def phase_env(torch) -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(
        f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, TF32 off"
    )
    from grl_torch.ops import _build

    start = time.perf_counter()
    paths = _build.build(_build.SOURCES)
    build_s = time.perf_counter() - start
    log(f"[env] built {sorted(paths)} for sm_90a in {build_s:.2f} s")
    for name, text in sorted(_build.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[env] ptxas {name}: {line.strip()}")
    return card


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------
def time_ms(torch, fn, flush, reps: int = 40) -> float:
    """Median device time of one call, L2 flushed before each call."""
    for _ in range(3):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(reps)
    ]
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in events)


def kernel_case(torch, dtype_name: str, N: int, F: int, density: float, flush, seed: int):
    from grl_torch.ops.relagg import neighbor_aggregate, neighbor_aggregate_reference

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn(B, N, F, generator=gen, device="cuda").to(dtype)
    A = (torch.rand(B, N, L, N, generator=gen, device="cuda") < density).to(dtype)

    ref = neighbor_aggregate_reference(V, A)
    out = neighbor_aggregate(V, A)
    torch.cuda.synchronize()
    require(out.shape == (B, N, L, F) and out.dtype == dtype, f"K3 output {out.shape} {out.dtype}")
    require(bool(torch.isfinite(out).all()), "K3 output is not finite")
    diff = (out.float() - ref.float()).abs()
    scale = ref.float().abs()
    limit = RTOL[dtype_name] * scale + ATOL_OF_MAX * float(scale.max())
    worst = float((diff - limit).max())
    max_abs_err = float(diff.max())
    require(
        worst <= 0.0,
        f"K3 disagrees with its plain version: {dtype_name} N={N} F={F} "
        f"density={density} max_abs_err={max_abs_err:.3e}",
    )

    ms = time_ms(torch, lambda: neighbor_aggregate(V, A), flush)
    plain_ms = time_ms(torch, lambda: neighbor_aggregate_reference(V, A), flush)
    A2 = A.view(B, N * L, N)
    library_ms = time_ms(torch, lambda: torch.matmul(A2, V), flush)

    itemsize = V.element_size()
    nbytes = itemsize * (B * N * L * N + B * N * F + B * N * L * F)
    flops = 2 * B * N * L * N * F
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return {
        "dtype": dtype_name, "B": B, "N": N, "L": L, "F": F, "density": density,
        "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "bytes": nbytes, "flops": flops,
    }


def phase_kernel(torch):
    # 256 MiB, five times the H100's 50 MB L2, zeroed before each timed call.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    cases = [
        (dtype_name, N, F, SPARSE_DENSITY)
        for dtype_name in ("float32", "bfloat16")
        for N in KERNEL_NS
        for F in KERNEL_FS
    ] + [("float32", 192, 512, DENSE_DENSITY), ("bfloat16", 192, 512, DENSE_DENSITY)]
    results = []
    for seed, case in enumerate(cases):
        row = kernel_case(torch, *case, flush=flush, seed=seed)
        results.append(row)
        log(
            f"[kernel] K3 {row['dtype']:>8} B={B} N={row['N']:3d} L={L} F={row['F']} "
            f"density={row['density']}: max_abs_err {row['max_abs_err']:.3e} | "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"torch.matmul {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})"
        )
    del flush
    return results


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------
def write_inputs(tmp: str, seed: int):
    """classes.json (26 classes), charset.json (4365 chars) and 64 pages."""
    from grl_torch.data.synthetic import DEFAULT_CLASSES, synthetic_page

    classes = list(DEFAULT_CLASSES) + [
        f"field_{i:02d}" for i in range(NUM_CLASSES - len(DEFAULT_CLASSES))
    ]
    pages = [
        synthetic_page(seed + i, num_rows=110, noise_lines=10, classes=classes)
        for i in range(PAGES)
    ]
    chars = set("0()-.,")
    for page in pages:
        for box in page:
            chars.update(box["text"].lower())
    # Pad to the production charset size, as scripts/bench_inference.py does.
    pad = (chr(0x4E00 + i) for i in range(CHARSET_SIZE))
    while len(chars) < CHARSET_SIZE:
        chars.add(next(pad))
    classes_path = os.path.join(tmp, "classes.json")
    charset_path = os.path.join(tmp, "charset.json")
    with open(classes_path, "w") as handle:
        json.dump({"classes": classes}, handle)
    with open(charset_path, "w") as handle:
        json.dump({"charset": sorted(chars)}, handle)
    samples = [[{"location": box["location"], "text": box["text"]} for box in page] for page in pages]
    return classes_path, charset_path, samples


def serve_config(tmp, classes_path, charset_path, checkpoint, kernel_impl, compute_dtype):
    return {
        "experiment_name": f"serve-{kernel_impl}-{compute_dtype}",
        "seed": 0,
        "is_train": False,
        "output_dir": os.path.join(tmp, "out"),
        "checkpoint_path": checkpoint,
        "model": {
            "type": "GraphCNNDropEdge",
            "args": {
                "input_dim": CHARSET_SIZE + 4,
                "output_dim": NUM_CLASSES * 2 + 1,
                "num_edges": 6,
                "net_size": NET_SIZE,
                "kernel_impl": kernel_impl,
                "compute_dtype": compute_dtype,
            },
        },
        "procedure": {"type": "KVInference", "args": {"batch_size": B}},
        "inference_settings": {
            "datasets": {
                "type": "CassiaDataset",
                "args": {
                    "charset_path": charset_path,
                    "class_path": classes_path,
                    "key_types": ["key", "value"],
                    "data_process": {
                        "TextlineEncoding": {"is_normalized_text": True},
                        "HeuristicGraphBuilder": {"num_edges": 6, "edge_type": "normal_binary"},
                    },
                },
            },
            "post_processing": [],
        },
    }


def flat_predictions(pages):
    keys, confidences = [], []
    for page in pages:
        for box in page:
            keys.append((box["formal_key"], box["key_type"]))
            confidences.append(box["confidence"])
    return keys, confidences


def check_pages(pages, samples, valid_keys):
    require(len(pages) == len(samples), f"{len(pages)} pages back for {len(samples)} sent")
    for page, sample in zip(pages, samples):
        require(len(page) == len(sample), "a page came back with another box count")
        for box, sent in zip(page, sample):
            require(box["text"] == sent["text"], "boxes came back out of order")
            require((box["formal_key"], box["key_type"]) in valid_keys, f"unknown class {box}")
            conf = box["confidence"]
            require(conf == conf and 0.0 < conf <= 1.0, f"confidence {conf} out of (0, 1]")


def phase_serve(torch):
    import grl_torch
    from grl_torch.models import create_model
    from grl_torch.ops import relagg
    from grl_torch.utils.checkpoint import CheckpointHandler

    tmp = tempfile.mkdtemp(prefix="grl_torch_smoke_")
    classes_path, charset_path, samples = write_inputs(tmp, seed=1000)
    boxes = sum(len(page) for page in samples)
    # Random weights from a seed, at full width, saved with the port's
    # checkpoint module: the warper loads them as a user's checkpoint.
    args = serve_config(tmp, classes_path, charset_path, "", "pallas", "bfloat16")["model"]["args"]
    model = create_model(
        "GraphCNNDropEdge", **args, device="cuda", generator=torch.Generator().manual_seed(0)
    )
    checkpoint = CheckpointHandler().save_checkpoint(
        {"model": model.state_dict()}, os.path.join(tmp, "weights")
    )
    del model

    def warper(kernel_impl, compute_dtype):
        config = serve_config(tmp, classes_path, charset_path, checkpoint, kernel_impl, compute_dtype)
        return grl_torch.GNNLearningWarper(config=config)

    main = warper("pallas", "bfloat16")
    valid_keys = set(main.inferencer.id_to_class.values())
    encoded = main.inferencer._encode_samples(samples)
    sizes = [n for _, n in encoded]
    batches = -(-PAGES // B)
    log(
        f"[serve] {PAGES} pages, {boxes} boxes, nodes per page {min(sizes)}..{max(sizes)}, "
        f"{batches} batches of {B}, input_dim {CHARSET_SIZE + 4}, output_dim {NUM_CLASSES * 2 + 1}"
    )
    main.predict(samples[:B])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()

    # The main path: every launch count starts at 0 here.
    relagg.neighbor_aggregate.launches = 0
    walls = []
    for _ in range(SERVE_REPEATS):
        start = time.perf_counter()
        out = main.predict(samples)
        walls.append(time.perf_counter() - start)
    launches = relagg.neighbor_aggregate.launches
    expected = 3 * batches * SERVE_REPEATS
    require(
        launches == expected,
        f"K3 launched {launches} times on the main path, expected {expected} "
        f"(3 GraphConvs x {batches} batches x {SERVE_REPEATS} requests)",
    )
    check_pages(out, samples, valid_keys)
    best = min(walls)
    log(
        f"[serve] {torch.cuda.get_device_name(0)}, kernel_impl=pallas bf16: best of {SERVE_REPEATS} requests {best:.3f} s "
        f"({[round(w, 3) for w in walls]}): {PAGES / best:.2f} pages/s, "
        f"{boxes / best:.1f} boxes/s; K3 launches {launches} = 3 x {batches} x {SERVE_REPEATS}"
    )

    # Where the request's time goes: the host's processors (text features,
    # the Python graph builder), padding and the copy to the card, and the
    # device time of the model forward over all batches.
    encode_s, stage_s = timed_encode(main.inferencer, samples)
    copy_s, device_ms = forward_device_ms(torch, main.inferencer, encoded)
    stages = ", ".join(f"{name} {sec:.3f} s" for name, sec in stage_s.items())
    log(
        f"[serve] breakdown of the {best:.3f} s request: host encode {encode_s:.3f} s ({stages}); "
        f"pad + copy to the card {copy_s:.3f} s; device forward of {batches} batches "
        f"{device_ms:.3f} ms (device idle share {1 - device_ms / 1e3 / best:.4f})"
    )

    agreement = {}
    reference = {"bfloat16": out}
    for dtype_name in ("bfloat16", "float32"):
        kernel_pages = reference.get(dtype_name) or warper("pallas", dtype_name).predict(samples)
        check_pages(kernel_pages, samples, valid_keys)
        plain_pages = warper("xla", dtype_name).predict(samples)
        check_pages(plain_pages, samples, valid_keys)
        k_keys, k_conf = flat_predictions(kernel_pages)
        p_keys, p_conf = flat_predictions(plain_pages)
        same = sum(a == b for a, b in zip(k_keys, p_keys)) / len(k_keys)
        conf_err = max(abs(a - b) for a, b in zip(k_conf, p_conf))
        min_same, max_conf_err = SERVE_AGREEMENT[dtype_name]
        log(
            f"[serve] pallas vs xla, {dtype_name}: classes agree on {same:.5f} of {len(k_keys)} "
            f"boxes (need >= {min_same}), max confidence diff {conf_err:.3e} (need <= {max_conf_err})"
        )
        require(same >= min_same and conf_err <= max_conf_err, f"kernel path disagrees ({dtype_name})")
        agreement[dtype_name] = {"class_agreement": same, "max_confidence_diff": conf_err}

    return {
        "pages": PAGES, "boxes": boxes, "batch_size": B, "batches": batches,
        "nodes_min": min(sizes), "nodes_max": max(sizes),
        "request_s": walls, "pages_per_s": PAGES / best, "boxes_per_s": boxes / best,
        "host_encode_s": encode_s, "host_stage_s": stage_s, "pad_copy_s": copy_s,
        "device_forward_ms": device_ms,
        "k3_launches": launches, "agreement": agreement,
    }


def timed_encode(inferencer, samples):
    """Encode a request as KVInference does, timing each host processor."""
    dataset = inferencer.dataset
    processors = dataset.data_processors
    stage_s = {type(p).__name__: 0.0 for p in processors}

    def timed(processor):
        def call(sample):
            start = time.perf_counter()
            out = processor(sample)
            stage_s[type(processor).__name__] += time.perf_counter() - start
            return out
        return call

    dataset.data_processors = [timed(p) for p in processors]
    try:
        start = time.perf_counter()
        inferencer._encode_samples(samples)
        return time.perf_counter() - start, stage_s
    finally:
        dataset.data_processors = processors


def forward_device_ms(torch, inferencer, encoded):
    """(host seconds to pad and copy a request's batches to the card,
    device milliseconds of the model forward over them)."""
    import numpy as np

    from grl_torch.data.collate import next_bucket

    order = sorted(range(len(encoded)), key=lambda i: encoded[i][1])
    start_s = time.perf_counter()
    tensors = []
    for begin in range(0, len(order), inferencer.batch_size):
        chunk = order[begin:begin + inferencer.batch_size]
        bucket = next_bucket(max(encoded[i][1] for i in chunk), quantum=64)
        V = np.zeros((len(chunk), bucket, encoded[chunk[0]][0]["textline_encoding"].shape[-1]), np.float32)
        A = np.zeros((len(chunk), bucket, 6, bucket), np.float32)
        for row, i in enumerate(chunk):
            sample, n = encoded[i]
            V[row, :n] = sample["textline_encoding"]
            A[row, :n, :, :n] = sample["adjacency_matrix"]
        tensors.append((torch.from_numpy(V).cuda(), torch.from_numpy(A).cuda()))
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - start_s
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        inferencer._forward(*tensors[0])
        torch.cuda.synchronize()
        start.record()
        for V, A in tensors:
            inferencer._forward(V, A)
        end.record()
        torch.cuda.synchronize()
    return copy_s, start.elapsed_time(end)


# ---------------------------------------------------------------------------
def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "grl_torch")):
        log("FAIL: the grl_torch package is not beside chip_smoke.py; run from a checkout")
        return 1
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke test runs on an NVIDIA GPU")
        return 1
    sys.path.insert(0, REPO)
    torch.cuda.set_device(0)

    card = phase_env(torch)
    kernel_rows = phase_kernel(torch)
    serve = phase_serve(torch)

    main_row = next(
        r for r in kernel_rows
        if (r["dtype"], r["N"], r["F"], r["density"]) == ("bfloat16", 256, NET_SIZE, SPARSE_DENSITY)
    )
    kernels = [{
        "name": "K3 relational neighbor aggregation",
        "route": "cuda",
        "source": "grl_torch/csrc/relagg.cu",
        "replaces": "grl_tpu/ops/pallas/relagg.py:127 pallas_neighbor_aggregate",
        "launches": serve["k3_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "bf16 B=8 N=256 L=6 F=256",
    }]
    record = {"card": card, "kernel_cases": kernel_rows, "serve": serve, "kernels": kernels}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as handle:
        json.dump(record, handle, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
