"""GPU wall time for the dense_inference demo.

The in-env compiled reference binary runs the 320x240x21 demo in
214-303 ms/image, best of 3, including PPM IO + lattice build
(/root/reference/third-party/densecrf/examples/dense_inference.cpp:86-101;
BASELINE.md). This measures the CLI (cli/dense_inference.py) on the same
three PPM pairs with the same span: load -> unary -> CRF setup (incl.
lattice builds) -> mean field -> colorize -> save.

Measures BOTH demo paths — host lattice build (models/crf.py) and the
fully-on-device build (models/crf2d_device.py) — and verifies each against
the compiled-reference goldens in tests/golden/.

Usage: python scripts/bench_dense_inference.py <densecrf examples dir>

Needs a GPU. Prints one JSON line with per-image best-of-3 warm wall times,
the cold (compile-included) first-run time, the device and the card.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from rovinasemanticsegmentation_tpu.cli.dense_inference import run  # noqa: E402
from rovinasemanticsegmentation_tpu.utils.compile_cache import (  # noqa: E402
    setup_compile_cache,
)
from rovinasemanticsegmentation_tpu.utils.device import (  # noqa: E402
    card_label,
    require_gpu,
)
from rovinasemanticsegmentation_tpu.utils.imageio import load_ppm  # noqa: E402

GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "tests", "golden"
)


def _measure_path(examples, out_dir, device_build):
    """Best-of-3 warm per image for one path + golden parity of the first."""
    out, cold_ms, parity = {}, None, True
    for i in (1, 2, 3):
        im = f"{examples}/im{i}.ppm"
        anno = f"{examples}/anno{i}.ppm"
        dst = os.path.join(out_dir, f"dense_out{i}.ppm")
        t0 = time.perf_counter()
        run(im, anno, dst, device_build=device_build)
        first = (time.perf_counter() - t0) * 1000.0
        if cold_ms is None:
            cold_ms = first
        same = np.array_equal(
            load_ppm(dst), load_ppm(f"{GOLDEN}/out{i}_ref.ppm")
        )
        parity &= bool(same)
        best = 1e18
        for _ in range(3):
            t0 = time.perf_counter()
            run(im, anno, dst, device_build=device_build)
            best = min(best, (time.perf_counter() - t0) * 1000.0)
        out[f"im{i}"] = best
        print(
            f"im{i} device_build={device_build}: warm best {best:.3f} ms "
            f"(first {first:.3f} ms, golden={'OK' if same else 'MISMATCH'})",
            file=sys.stderr,
        )
    return out, cold_ms, parity


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    examples = sys.argv[1]
    device = require_gpu()
    card = card_label()
    setup_compile_cache()
    with tempfile.TemporaryDirectory() as out_dir:
        host_out, host_cold, host_par = _measure_path(examples, out_dir, False)
        dev_out, dev_cold, dev_par = _measure_path(examples, out_dir, True)
    record = {
        "metric": "dense_inference_ms_per_image",
        "unit": "ms (best-of-3 warm, full span incl. IO + lattice build)",
        "per_image_host_build": host_out,
        "per_image_device_build": dev_out,
        "golden_parity": {"host": host_par, "device": dev_par},
        "cold_first_ms": {"host": host_cold, "device": dev_cold},
        "reference_ms": "214-303 (in-env C++ -O2, BASELINE.md)",
        "device": device,
        "card": card,
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
