#!/bin/sh
# Compile every kernel source of the port on its own (nvcc, sm_90a, the
# build's flags) and print each one's errors: a check of the sources that,
# unlike ops/build.py, reports every failing file at once.  Run on a machine
# with the CUDA toolkit, from the repository root.
NVCC=${NVCC:-$(command -v nvcc || echo /usr/local/cuda/bin/nvcc)}
out=$(mktemp -d)
for f in degnorm_tpu_torch/csrc/*.cu; do
  ( "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
      -Xcompiler -fPIC -c "$f" -o "$out/$(basename "$f").o" \
      > "$out/$(basename "$f").log" 2>&1 || echo "FAILED $f" ) &
done
wait
grep -h -B1 -A2 "error" "$out"/*.log | head -n 120
rm -rf "$out"
