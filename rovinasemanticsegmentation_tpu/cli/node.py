"""The online segmentation node: config -> Segmenter -> HTTP services.

Capability parity with the node entry point + launch file
(``/root/reference/src/semantic_segmentation_node.cpp:13-51``,
``launch/semantics.launch:1-31``): reads the config path, the (color, depth)
topic pairs, the external-semantics flag and the cloud-dump flag, constructs
the Segmenter, exposes the three query services, and spins. ROS parameters
become command-line flags; ROS services become the HTTP endpoints of
``serve/services.py``.

Usage:
  python -m rovinasemanticsegmentation_tpu.cli.node \
      --conf <config.json> \
      --topics '["/camera_front/rgb/image", "/camera_front/depth/image"]' \
      --forest <forest.dat> \
      [--external_semantics false] [--dump_clouds_to_tmp false] \
      [--port 8090]
"""

from __future__ import annotations

import json
import signal
import sys
import threading

from ..serve.segmenter import Segmenter
from ..serve.services import (
    SegmentationServiceServer,
    heuristic_single_frame_segmentation,
)
from ..utils.compile_cache import setup_compile_cache
from ..utils.config import Config, parse_cli_overrides


def build_segmenter(params: dict) -> Segmenter:
    config_file = params.pop("conf")
    topics = json.loads(params.pop("topics"))
    forest_path = params.pop("forest", None)
    external = json.loads(params.pop("external_semantics", "false"))
    dump = json.loads(params.pop("dump_clouds_to_tmp", "false"))
    conf = Config(config_file, params)

    external_fn = None
    if external:
        # The in-process equivalent of launching the stub server
        # (launch/semantics.launch:13-17).
        layers = [len([c for c in l["coding"] if int(c["label"]) >= 0])
                  for l in conf.get_raw("color_codings")]
        external_fn = lambda rgb, depth3d: heuristic_single_frame_segmentation(  # noqa: E731
            rgb, depth3d, layers
        )
    return Segmenter(
        conf,
        topic_names=topics,
        forest_path=None if external else forest_path,
        external_segmentation=external_fn,
        dump_clouds_to_tmp=dump,
    )


def main(argv=None) -> None:
    params = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    if "conf" not in params or "topics" not in params:
        raise SystemExit(
            "Usage: node --conf <config.json> --topics '[...]' "
            "[--forest <forest.dat>] [--external_semantics bool] [--port N]"
        )
    port = int(params.pop("port", "8090"))
    setup_compile_cache()
    segmenter = build_segmenter(params)
    server = SegmentationServiceServer(segmenter, port=port)
    server.start()
    print(f"semantic_segmentation node serving on {server.address}")

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    stop.wait()
    server.stop()
    segmenter.stop()


if __name__ == "__main__":
    main()
