"""``python -m deepspeed_tpu_torch.checkpoint.ds_to_universal_cli`` — convert an
engine checkpoint into the universal interchange format (counterpart of
``deepspeed_tpu/checkpoint/ds_to_universal_cli.py``; reference:
``deepspeed/checkpoint/ds_to_universal.py`` CLI).

The universal tree is mesh-free (one npz per component, arrays whole, and a
JSON manifest), so the output resumes on any mesh and ZeRO stage of either
package (checkpoint/universal_checkpoint.py).
"""

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "ds_to_universal", description="engine checkpoint -> universal format"
    )
    ap.add_argument("--input_folder", required=True, help="engine checkpoint dir")
    ap.add_argument("--output_folder", required=True, help="universal output dir")
    ap.add_argument("--tag", default=None, help="checkpoint tag (default: latest)")
    args = ap.parse_args(argv)

    from deepspeed_tpu_torch.checkpoint.universal_checkpoint import ds_to_universal

    manifest = ds_to_universal(args.input_folder, args.output_folder, tag=args.tag)
    print(json.dumps({"output": args.output_folder, "tag": manifest.get("tag"),
                      "tensors": len(manifest.get("tensors", {}))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
