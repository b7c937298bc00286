#!/bin/bash
# Compare the machine code (SASS) of CUDA sources built from two csrc
# directories, e.g. the parent commit's and this tree's, on a machine with
# the CUDA toolkit:
#
#   bash tools/torch_kernel_sass_diff.sh OLD_CSRC NEW_CSRC xattn_layer xattn_layer_bwd
#   SASS_FUNCS='scan_fwd_kernel|scan_adjcarry_kernel' \
#     bash tools/torch_kernel_sass_diff.sh OLD_CSRC NEW_CSRC selective_scan
#
# Each NAME.cu is compiled as ops/_kernels.py compiles it (sm_90a, -O3) from
# both directories, disassembled with cuobjdump, and the anonymous-namespace
# hash that nvcc derives from the file's path is normalised. With SASS_FUNCS
# (an awk regular expression) only the functions whose mangled names match
# it are compared. Prints the number of differing lines per file (0: the
# same code); exits 1 on any difference.
set -euo pipefail
old=$1 new=$2
shift 2
cuda=${CUDA_HOME:-/usr/local/cuda}
work=$(mktemp -d)
trap 'rm -rf "$work"' EXIT
status=0
for name in "$@"; do
  for side in old new; do
    dir=${!side}
    "$cuda/bin/nvcc" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c \
      -Xcompiler -fPIC -I "$dir" -o "$work/$side.$name.o" "$dir/$name.cu"
    "$cuda/bin/cuobjdump" -sass "$work/$side.$name.o" \
      | sed -E 's/_GLOBAL__N__[0-9a-f]+_[0-9]+_[a-z_]+_cu_[0-9a-f]+/ANON/g' \
      | awk -v pat="${SASS_FUNCS:-}" 'pat == "" {print; next}
                                      /Function :/ {keep = ($0 ~ pat)} keep' \
      > "$work/$side.$name.sass"
  done
  lines=$(diff "$work/old.$name.sass" "$work/new.$name.sass" | wc -l || true)
  echo "$name${SASS_FUNCS:+ ($SASS_FUNCS)}: $(wc -l < "$work/new.$name.sass") lines of SASS," \
    "$lines differing"
  [ "$lines" -eq 0 ] || status=1
done
exit $status
