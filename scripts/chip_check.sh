#!/bin/bash
# Checks the PyTorch/CUDA port on a machine with one H100, in one go:
# chip_smoke.py (each line of its output prefixed with the seconds since
# it started), then the card tests (tests/test_torch_cuda.py), then
# chip_smoke.py alone in an empty directory, where it must fail without
# printing a result.
#
#     bash scripts/chip_check.sh OUT [TREE [BASE]]
#
# SMOKE="scripts/phases.py families" (or another script of the tree that
# takes --out, with its arguments) runs that script in place of
# chip_smoke.py, here and in the script-alone check.
#
# OUT receives smoke.log, smoke.err, cuda_tests.log and chip_smoke.py's
# long outputs; TREE (default: the current directory) is the checkout to
# run, for example an unpacked `git archive` of the tree.  BASE, another
# checkout (say, the parent commit's), adds a last step: every kernel's
# check of chip_smoke.py (check_paged_decode, check_paged_flash,
# check_dense_flash, check_flash_bwd, check_dense_decode, check_mamba_scan,
# check_mlstm, check_chunk_hash), then train_bf16's steps, in turns BASE, TREE,
# TREE, BASE, each tree building and timing its own kernels on this card, one
# JSON line a kernel (and one for the training step) in OUT/turns.log.  A summary of each step is printed at the end.
set -u
out=$(realpath -m "$1")
mkdir -p "$out"
base=""
[ $# -ge 3 ] && base=$(realpath "$3")
cd "${2:-.}" || exit 2
tree=$(pwd)

read -r smoke smoke_args <<< "${SMOKE:-chip_smoke.py}"
t0=$(date +%s)
# shellcheck disable=SC2086  # the script's arguments, split on spaces
python3 "$smoke" $smoke_args --out "$out" 2> "$out/smoke.err" |
    while IFS= read -r line; do echo "$(( $(date +%s) - t0 )) $line"; done > "$out/smoke.log"
smoke_rc=${PIPESTATUS[0]}
echo "$smoke rc=$smoke_rc after $(( $(date +%s) - t0 )) s"
tail -n 3 "$out/smoke.log" | cut -c1-300
tail -c 1500 "$out/smoke.err"

PYTHONPATH=src python3 -m pytest -q -p no:cacheprovider -m cuda tests/test_torch_cuda.py \
    > "$out/cuda_tests.log" 2>&1
tests_rc=$?
echo "card tests rc=$tests_rc"
tail -n 3 "$out/cuda_tests.log"

alone=$(mktemp -d)
cp "$smoke" "$alone/"
# shellcheck disable=SC2086
(cd "$alone" && python3 "$(basename "$smoke")" $smoke_args > stdout.txt 2> stderr.txt
 rc=$?; echo "$(basename "$smoke") alone rc=$rc with $(wc -c < stdout.txt) bytes of output")
rm -rf "$alone"

turns_rc=0
if [ -n "$base" ]; then
    for t in "$base" "$tree" "$tree" "$base"; do
        (cd "$t" && python3 - <<'EOF'
import json
import os

import torch

import chip_smoke as c
from repro_torch.kernels import _build

_build.build_all()
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
for check in (c.check_paged_decode, c.check_paged_flash, c.check_dense_flash,
              c.check_flash_bwd, c.check_dense_decode, c.check_mamba_scan, c.check_mlstm,
              c.check_chunk_hash):
    r = check(0 if check is c.check_chunk_hash else gen, dev)
    print(json.dumps({"tree": os.getcwd(), **{k: r.get(k) for k in (
        "name", "ms", "plain_ms", "library_ms", "bound_ms", "serving", "shapes",
        "timed_more")}}),
        flush=True)
c._free()
line, _ = c.train_bf16(0, dev, None)
print(json.dumps({"tree": os.getcwd(), "name": "train_bf16",
                  **{k: line[k] for k in ("mean_step_s", "tokens_per_s", "losses")},
                  **{k: line["traced_step"][k] for k in ("idle_share", "kernels")}}),
      flush=True)
EOF
        ) >> "$out/turns.log" 2>&1 || turns_rc=1
    done
    echo "kernel turns rc=$turns_rc"
    grep '^{' "$out/turns.log" | cut -c1-600
fi
[ "$smoke_rc" -eq 0 ] && [ "$tests_rc" -eq 0 ] && [ "$turns_rc" -eq 0 ]
