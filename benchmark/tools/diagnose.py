"""Where a serving cell's program and reference part: the look behind a
served-token gap.

    python3 benchmark/tools/diagnose.py --workload <cell> --seed <n> [--batch K]

For one batch of the cell's pool (default: the longest), it compares, frame
by frame, the program's features (``Evaluator.featurizer``) with the
reference's, and the emissions of four pairings: program on its own
features, program on the reference's features, reference on the program's
features, reference on its own. It prints JSON lines: the largest gaps and
where they lie (frame index, the row's length).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _where(diff, lens):
    """diff (B, T) -> the largest entry and where: row, frame, row length."""
    b, t = divmod(int(diff.argmax()), diff.shape[1])
    return {"max": float(diff.max()), "row": b, "frame": t, "row_frames": int(lens[b])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--batch", type=int, default=-1)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.core import manifest, runner, system, traffic, weights
    from benchmark.reference.steps import Reference

    runner.environment(ROOT)
    cell = manifest.Cell(args.workload)
    cfg, mix, dev = cell.config, cell.traffic, args.device
    n = int(cfg["n_classes"])
    work = tempfile.mkdtemp(prefix="w2l-diagnose-")
    files = system.write_files(work, n, cfg["flags"].get("wordseparator", "|"))
    w = weights.seeded(system.param_shapes(cfg), args.seed, dev)
    inputs = {k: t.cpu() for k, t in w.items()}
    shape = traffic.pool(mix)[args.batch]
    batch = traffic.make_batch(shape, args.seed, n, dev)
    prog = system.InferSystem(cfg, files, args.seed, dev, w, int(mix["batch"]))
    ev = prog.ev
    ref = Reference(manifest.arch_lines(cfg), cfg["flags"], n, inputs, dev)
    with torch.no_grad():
        audio = torch.as_tensor(batch["audio"]).to(dev)
        alen = torch.as_tensor(batch["audio_len"]).to(dev)
        fp, flen_p = ev.featurizer(audio, alen)
        fr, flen_r = ref.features(batch)
        lens = flen_r.cpu()
        print(json.dumps({"features": _where((fp.float() - fr).abs().amax(-1), lens),
                          "flen_equal": bool((flen_p.long().cpu() == lens).all())}), flush=True)
        pos = (fp.float() - fr).abs().amax(-1).amax(0)  # by frame
        print(json.dumps({"feature_gap_by_frame": {
            "first_8": [float(x) for x in pos[:8]], "median": float(pos.median()),
            "frames_over_0.01": int((pos > 0.01).sum())}}), flush=True)

        def program_on(feats):
            em, el = ev.model(feats.to(ev.dtype), flen_p)
            return em.float(), el

        def reference_on(feats):
            ems = []
            for r0 in range(0, feats.shape[0], 16):
                rows = slice(r0, min(feats.shape[0], r0 + 16))
                ems.append(ref.model.forward(ref.params, feats[rows].float(), flen_r[rows],
                                             feats.shape[1], rows)[0])
            return torch.cat(ems)

        base = reference_on(fr)
        el = torch.ceil(flen_r.float() / fp.shape[1] * base.shape[1]).long().cpu()
        valid = torch.arange(base.shape[1])[None, :] < el[:, None]
        for name, em in (("program", program_on(fp)[0]), ("program_on_reference_features",
                                                          program_on(fr)[0]),
                         ("reference_on_program_features", reference_on(fp))):
            d = (em - base).abs().amax(-1).cpu() * valid
            best = base.argmax(-1)
            gap = (base.max(-1).values - base.gather(-1, em.argmax(-1)[..., None])[..., 0])
            gap = gap.cpu() * valid
            print(json.dumps({name: {"emission_gap": _where(d, el), "token_gap": _where(gap, el),
                                     "argmax_agree": float(((em.argmax(-1) == best).cpu()
                                                            | ~valid).float().mean())}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
