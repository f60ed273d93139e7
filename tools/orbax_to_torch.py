#!/usr/bin/env python3
"""Convert a reference checkpoint directory (orbax) into the PyTorch
port's checkpoint format.

    JAX_PLATFORMS=cpu python tools/orbax_to_torch.py --checkpoint DIR \
        [--out DIR]

DIR is what tools/convert_hf.py (or the reference trainer) writes:
``lm_config.json`` and an orbax ``params/`` tree. The tool restores the
tree against the reference's ``init_params`` tree for the checkpoint's
own config (as the reference's ``LMServer(checkpoint=)`` does), maps it
with the port's ``params_from_jax`` in float32 (nothing rounded) and
writes ``torch_params.pt`` + ``lm_config.json`` with the port's
``save_checkpoint``, copying any tokenizer files. ``--out`` defaults to
DIR, so one directory serves both daemons:

    python tools/convert_hf.py --model <hf-dir> --out DIR
    JAX_PLATFORMS=cpu python tools/orbax_to_torch.py --checkpoint DIR
    python -m k8s_device_plugin_tpu_torch.models.serve --checkpoint DIR

This is the only code that imports both packages; the port itself reads
torch files only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_dir: str, out_dir: str | None = None) -> str:
    """Convert ``ckpt_dir`` into ``out_dir`` (default: ``ckpt_dir``);
    returns the path of the written weights."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from k8s_device_plugin_tpu.models import transformer as jt
    from k8s_device_plugin_tpu.utils.jaxenv import reassert_platforms
    from k8s_device_plugin_tpu_torch.models import params as tparams
    from k8s_device_plugin_tpu_torch.models.transformer import LMConfig

    reassert_platforms()  # honor JAX_PLATFORMS even when jax is pre-imported
    ckpt_dir = os.path.abspath(ckpt_dir)
    out_dir = os.path.abspath(out_dir or ckpt_dir)
    with open(os.path.join(ckpt_dir, tparams.CONFIG_FILE)) as f:
        cfg_dict = json.load(f)
    # The restore target comes from the checkpoint's own config: orbax
    # restores leaves into the shapes it is given.
    target = jt.init_params(jax.random.PRNGKey(0),
                            jt.LMConfig.from_json_dict(cfg_dict))
    path = os.path.join(ckpt_dir, "params")
    if not os.path.exists(path):
        path = ckpt_dir
    tree = ocp.StandardCheckpointer().restore(path, target)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    config = LMConfig.from_json_dict(cfg_dict)
    state = tparams.params_from_jax(tree, config, param_dtype=torch.float32)
    written = tparams.save_checkpoint(out_dir, config, state)
    if out_dir != ckpt_dir:
        for name in tparams.TOKENIZER_FILES:
            src = os.path.join(ckpt_dir, name)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, name))
    print(f"wrote {written} + {tparams.CONFIG_FILE}")
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="orbax-to-torch")
    p.add_argument("--checkpoint", required=True,
                   help="reference checkpoint dir (lm_config.json + "
                        "orbax params/)")
    p.add_argument("--out", default=None,
                   help="output dir for the port's checkpoint (default: "
                        "--checkpoint itself)")
    args = p.parse_args(argv)
    convert(args.checkpoint, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
