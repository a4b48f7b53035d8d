"""Training checkpoint -> streaming bundle converter of the PyTorch port
(StreamingTDSModelConverter equivalent).

    python -m wav2letter_tpu_torch.cli.convert_streaming --am=run/model_last.bin \\
        --out=model.stream

``--am`` is a checkpoint of the port or a JAX ``W2LTPU01`` file; the bundle
is the port's (``inference/convert.py``). Conversion runs on the host.
"""

import sys


def parse_args(argv):
    out = {}
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            out[k] = v if v else "true"
    return out


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from ..inference import convert_checkpoint

    out = convert_checkpoint(args["am"], args.get("out", "model.stream"))
    print(f"wrote streaming bundle: {out}")
    return out


if __name__ == "__main__":
    main()
