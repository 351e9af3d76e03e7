#!/bin/sh
# Build the native codec shared library next to this script.
# Prefers cmake+ninja; falls back to a direct g++ invocation when they are
# missing or fail (a cmake whose ninja is not where it looks).
set -e
cd "$(dirname "$0")"
if command -v cmake >/dev/null 2>&1 && command -v ninja >/dev/null 2>&1 \
    && cmake -S . -B build -G Ninja >/dev/null && cmake --build build >/dev/null; then
  cp build/lib/libilr_native.so ./libilr_native.so
else
  g++ -O3 -march=native -std=c++17 -shared -fPIC exr_codec.cpp -o libilr_native.so -lz -lpthread
fi
echo "built $(pwd)/libilr_native.so"
