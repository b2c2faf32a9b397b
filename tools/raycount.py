#!/usr/bin/env python
"""Per-sample closest vs shadow ray split on the headline scene (the bench
headline only prints the sum). Usage: python tools/raycount.py [spp]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from metal_pathtracer.utils.compilecache import enable_cache

enable_cache()


def main():
    from metal_pathtracer.renderer import frame
    from metal_pathtracer.renderer.accumulation import RenderState
    from metal_pathtracer.utils.benchscene import build_bench_scene, \
        frame_inputs

    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    scene, static, uniforms = frame_inputs(*build_bench_scene(8), 1920, 1080)
    state = RenderState.create(static.width, static.height)
    state = frame.render_samples(scene, uniforms, state, static, spp)
    closest = float(np.asarray(state.ray_count)) / spp
    shadow = float(np.asarray(state.shadow_ray_count)) / spp
    lanes = static.width * static.height
    print(f"closest {closest/1e6:.3f}M/sample ({closest/lanes:.3f}/pixel)  "
          f"shadow {shadow/1e6:.3f}M/sample ({shadow/lanes:.3f}/pixel)  "
          f"total {(closest+shadow)/1e6:.3f}M/sample")


if __name__ == "__main__":
    main()
