"""Demo CLI of the port: track objects in a video file or an image folder
and write the overlays (counterpart of ``demos/demo.py``, same flags,
plus ``--device``).

    python -m siammot_tpu_torch.demos.demo --demo-video clip.avi \\
        --track-class person --model-file fixtures/bench_weights_f16.npz \\
        --dump-video True --output-path out/ [--device cpu]

Inputs: a folder of JPEG, PNG or BMP stills, or a video in an AVI, MP4,
MOV, Matroska (``.mkv``) or WebM file: Motion JPEG on the JPEG route;
H.264, HEVC, MPEG-4 Part 2, VP8, VP9 and AV1 through NVDEC on the card
(other codecs raise, naming the codec).  The model runs
on the card unless ``--device cpu`` asks for the CPU; without a card the
default raises.  Output: ``<output-path>/<name>.mp4`` (MJPEG) with
``--dump-video True``, else ``<output-path>/<name>_frames/%06d.jpg``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

from .demo_inference import DemoInference
from .utils.vis_generator import VisGenerator
from .utils.vis_writer import VisWriter
from .video_iterator import build_video_iterator


@dataclasses.dataclass
class DemoRun:
    rows: list            # per frame: (frame_id, (xywh, ids, labels, scores))
    tracks: set           # the track ids seen
    seconds: float        # the whole loop: decode, step, draw, encode
    step_seconds: float   # the model's steps
    draw_seconds: float   # drawing and encoding the overlays
    output: str           # the video written, or the frames' folder
    frame_seconds: list   # per frame: the loop's wall time
    frame_step_seconds: list    # per frame: its step


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="SiamMOT demo (PyTorch "
                                                 "port)")
    parser.add_argument("--demo-video", required=True,
                        help="video file or image folder")
    parser.add_argument("--track-class", default="person",
                        choices=("person", "person_vehicle"))
    parser.add_argument("--model-file", default=None,
                        help="port checkpoint (.pth or a directory), "
                             "reference .pth, or flax-tree .npz")
    parser.add_argument("--config-file", default=None,
                        help="override the bundled per-class config")
    parser.add_argument("--dump-video", type=lambda s: s.lower() == "true",
                        default=True)
    parser.add_argument("--vis-resolution", type=int, default=None,
                        help="output frame height")
    parser.add_argument("--output-path", default="demo_out")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model and the JPEG route "
                             "(default: the card)")
    return parser.parse_args(argv)


def main(argv=None) -> DemoRun:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    tracker = DemoInference(track_class=args.track_class,
                            model_path=args.model_file,
                            config_file=args.config_file,
                            device=args.device)
    frames = build_video_iterator(args.demo_video, args.device)
    tracker.vis_generator = VisGenerator(vis_height=args.vis_resolution)
    tracker.vis_writer = vis_writer = VisWriter(
        dump_video=args.dump_video, out_path=args.output_path,
        file_name=os.path.basename(os.path.normpath(args.demo_video)),
        fps=frames.fps, device=args.device)

    rows, tracks, frame_seconds, frame_step = [], set(), [], []
    t0 = last = time.perf_counter()
    stepped = 0.0
    try:
        for frame_id, out in tracker.process_frame_sequence(iter(frames)):
            now = time.perf_counter()
            frame_seconds.append(now - last)
            frame_step.append(tracker.step_seconds - stepped)
            last, stepped = now, tracker.step_seconds
            rows.append((frame_id, out))
            tracks.update(int(i) for i in out[1] if i >= 0)
    finally:
        vis_writer.close()
    seconds = time.perf_counter() - t0
    output = vis_writer.video_path if args.dump_video \
        else vis_writer.frame_dir
    logging.info("done: %d frames, %d tracks, output under %s", len(rows),
                 len(tracks), args.output_path)
    return DemoRun(rows=rows, tracks=tracks, seconds=seconds,
                   step_seconds=tracker.step_seconds,
                   draw_seconds=tracker.draw_seconds, output=output,
                   frame_seconds=frame_seconds,
                   frame_step_seconds=frame_step)


if __name__ == "__main__":
    main()
