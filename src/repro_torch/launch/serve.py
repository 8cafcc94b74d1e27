"""Batched-decoding server demo: prefill a prompt batch, then decode
tokens with the KV-cache serve step, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-3b \
        --reduced --batch 4 --prompt-len 32 --gen 32

The counterpart of ``repro/launch/serve.py``, with its flags as they are:
``--reduced`` is ``store_true`` with ``default=True``, so the CLI always
serves the reduced config (the reference's fault, ROADMAP.md queue 3).
``--device cpu`` runs the plain versions on the CPU. Every architecture of
the registry is served; for the audio family (Whisper) the CLI encodes
seeded frame embeddings (the stubbed frontend's output) and fills the
cross-attention K/V from them before decoding, which the reference's CLI
does not (ROADMAP.md queue 3, fault 11).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import api, encdec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init_params(cfg, generator=gen, device=device)
    rng = np.random.default_rng(args.seed)
    s_max = args.prompt_len + args.gen

    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(device)
    cache = api.init_cache(cfg, args.batch, s_max, device=device)
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)).to(device)
        with torch.inference_mode():
            memory = encdec.encode(params, cfg, frames)
            cache = encdec.prefill_cross(params, cfg, memory, cache)

    def decode(c, t, pos):
        return api.decode_step(params, cfg, c, t, pos)

    # prefill by teacher-forcing the prompt through the decode step (a
    # production server would batch-prefill).
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits = None
        for t in range(args.prompt_len):
            logits, cache = decode(cache, prompts[:, t:t + 1],
                                   torch.full((args.batch,), t, device=device))
        toks = torch.argmax(logits, -1)[:, None]
        out = [toks]
        for t in range(args.prompt_len, s_max):
            logits, cache = decode(cache, toks, torch.full((args.batch,), t, device=device))
            toks = torch.argmax(logits, -1)[:, None]
            out.append(toks)
        gen_toks = torch.cat(out, dim=1).cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
    total_tokens = args.batch * s_max
    print(f"{args.arch}: served {args.batch} seqs x ({args.prompt_len} prompt "
          f"+ {args.gen} generated) = {total_tokens} steps in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s)")
    print("sample generations (token ids):")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {gen_toks[b, :16]}")


if __name__ == "__main__":
    main()
