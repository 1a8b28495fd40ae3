"""chip_smoke.py: its contract without a GPU, and its phases rehearsed.

The phases run in-process on the CPU backend at tiny sizes (the CPU
stands in for the GPU, so the GPU-vs-CPU comparisons compare the CPU
with itself); the four-card phases run on four virtual CPU devices.
The run at real sizes is the ``gpu``-marked test, on the card.
"""

import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from gowebp_tpu.utils.corpus import natural_images  # noqa: E402


def _run(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = _run(REPO, env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run(tmp_path, env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_probe_exactness():
    cpu = jax.devices("cpu")[0]
    cs.probe_exactness(cpu, cpu, ctx_size=32)


def test_hybrid_batch_encode_and_decode():
    cpu = jax.devices("cpu")[0]
    imgs = natural_images(3, 64, 80, seed=7)
    exact = cs._host_encode(imgs)
    hybrid = cs.hybrid_batch_encode(imgs, exact)
    assert len(hybrid) == 3 and all(d[:4] == b"RIFF" for d in hybrid)
    cs.batch_decode(hybrid, "hybrid files", Image=cs._pil())
    cs.hybrid_core_gpu_vs_cpu(imgs[:2], cpu, cpu)
    cs.hybrid_core_memory(imgs, cpu)


def test_exact_wavefront_encode():
    cs.exact_wavefront_encode(natural_images(1, 48, 64, seed=3)[0])


def test_batch_decode_edge_files():
    Image = cs._pil()
    imgs = natural_images(2, 48, 64, seed=4)
    alpha = np.concatenate([imgs, np.broadcast_to(
        (np.arange(64)[None, :, None] % 255 + 1).astype(np.uint8),
        (2, 48, 64, 1))], axis=-1)
    cs.batch_decode(cs._host_encode(alpha), "alpha files", Image=Image)
    cs.batch_decode(cs._host_encode(natural_images(1, 47, 61, seed=8)),
                    "odd file", Image=Image)
    cs.batch_decode(cs._host_encode(natural_images(1, 16, 64, seed=9)),
                    "one MB row", Image=Image)
    lw = []
    for im in imgs:
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, "WEBP", quality=75, method=4)
        lw.append(buf.getvalue())
    cs.batch_decode(lw, "libwebp files", Image=Image)


def test_batch_decode_catches_a_wrong_device_result(monkeypatch):
    """The decode phase compares, it does not just run: a device path
    that returns other pixels fails it."""
    import importlib

    dec = importlib.import_module("gowebp_tpu.decode")
    files = cs._host_encode(natural_images(1, 32, 32, seed=5))
    real = dec.decode_rgba_batch

    def off_by_one(datas, **kw):
        out = real(datas, **kw)
        if kw.get("recon_backend") == "jax" and not kw.get("device_out"):
            out = [o ^ np.uint8(1) for o in out]
        return out

    monkeypatch.setattr(dec, "decode_rgba_batch", off_by_one)
    with pytest.raises(cs.SmokeFailure):
        cs.batch_decode(files, "tampered")


def test_lossless_encode_device_chooser():
    cs.lossless_encode(natural_images(1, 40, 56, seed=6)[0],
                       device_chooser=True)


def test_four_card_phases_on_virtual_devices():
    from gowebp_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(4)
    ref = jax.devices()[0]
    cs.four_card_hybrid(mesh, natural_images(4, 32, 48, seed=1), ref)
    # 3 MB rows over a 2-way tile axis: the dead-row padding path
    frames = cs._host_encode(natural_images(2, 48, 64, seed=10))
    cs.four_card_recon(mesh, frames, ref)
    cs.four_card_wavefront(mesh, natural_images(2, 64, 48, seed=3), ref)


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    """The whole smoke run at real sizes; needs an NVIDIA GPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("no GPU visible to JAX")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
