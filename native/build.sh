#!/bin/sh
# Build the native runtime library (C++17, no external deps).  The output
# is written under a temporary name and renamed, so concurrent builds
# (one per worker process) never load a half-written library.
set -e
cd "$(dirname "$0")"
tmp="libppsfm_native.so.tmp.$$"
g++ -O3 -std=c++17 -shared -fPIC -o "$tmp" graph.cpp
mv -f "$tmp" libppsfm_native.so
echo "built $(pwd)/libppsfm_native.so"
