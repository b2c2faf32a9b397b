#!/usr/bin/env bash
# Build the native helpers (C++ BVH builder; CPU oracle when present).
# Each library is linked to a temporary name and moved into place, so a
# process that already loaded the previous build keeps a valid mapping.
set -euo pipefail
cd "$(dirname "$0")"

CXX=${CXX:-g++}
# Fixed -march (x86-64-v3: AVX2/FMA, 2015+ hosts) instead of -march=native
# so every host builds the SAME oracle — parity RMSE gates are then
# reproducible across machines. Override with MPT_NATIVE_ARCH=native for
# local tuning.
ARCH=${MPT_NATIVE_ARCH:-x86-64-v3}
FLAGS="-O3 -march=$ARCH -fPIC -shared -std=c++17 -Wall"
echo "flags: $FLAGS"

$CXX $FLAGS bvh_builder.cpp -o libbvh_builder.so.tmp
mv -f libbvh_builder.so.tmp libbvh_builder.so
echo "built libbvh_builder.so"

if [[ -f cpu_oracle.cpp ]]; then
    $CXX $FLAGS -pthread cpu_oracle.cpp bvh_builder.cpp -o libcpu_oracle.so.tmp
    mv -f libcpu_oracle.so.tmp libcpu_oracle.so
    echo "built libcpu_oracle.so"
fi

CC=${CC:-gcc}
if [[ -f mikktspace/mikktspace.c ]]; then
    $CC -O2 -fPIC -shared tangentgen.c mikktspace/mikktspace.c \
        -o libtangentgen.so.tmp -lm
    mv -f libtangentgen.so.tmp libtangentgen.so
    echo "built libtangentgen.so"
fi
