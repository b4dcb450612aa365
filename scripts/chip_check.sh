#!/bin/bash
# Checks the PyTorch/CUDA port on a machine with one H100, in one go:
# chip_smoke.py (each line of its output prefixed with the seconds since
# it started), then the card tests (tests/test_torch_cuda.py), then
# chip_smoke.py alone in an empty directory, where it must fail without
# printing a result.
#
#     bash scripts/chip_check.sh OUT [TREE]
#
# OUT receives smoke.log, smoke.err, cuda_tests.log and chip_smoke.py's
# long outputs; TREE (default: the current directory) is the checkout to
# run, for example an unpacked `git archive` of the tree.  A summary of
# each step is printed at the end.
set -u
out=$(realpath -m "$1")
mkdir -p "$out"
cd "${2:-.}" || exit 2

t0=$(date +%s)
python3 chip_smoke.py --out "$out" 2> "$out/smoke.err" |
    while IFS= read -r line; do echo "$(( $(date +%s) - t0 )) $line"; done > "$out/smoke.log"
smoke_rc=${PIPESTATUS[0]}
echo "chip_smoke.py rc=$smoke_rc after $(( $(date +%s) - t0 )) s"
tail -n 3 "$out/smoke.log" | cut -c1-300
tail -c 1500 "$out/smoke.err"

PYTHONPATH=src python3 -m pytest -q -p no:cacheprovider -m cuda tests/test_torch_cuda.py \
    > "$out/cuda_tests.log" 2>&1
tests_rc=$?
echo "card tests rc=$tests_rc"
tail -n 3 "$out/cuda_tests.log"

alone=$(mktemp -d)
cp chip_smoke.py "$alone/"
(cd "$alone" && python3 chip_smoke.py > stdout.txt 2> stderr.txt
 echo "chip_smoke.py alone rc=$? with $(wc -c < stdout.txt) bytes of output")
rm -rf "$alone"
[ "$smoke_rc" -eq 0 ] && [ "$tests_rc" -eq 0 ]
