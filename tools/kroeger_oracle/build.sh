#!/bin/bash
# Build the reference CPU baseline (OF_DIS by Kroeger, mirrored at
# $FLOWONTHEGO_REFERENCE/kroeger) as a numerical oracle, using our minimal Eigen shim
# (tools/kroeger_oracle/eigen_shim). Nothing from the reference tree is copied
# into this repo; the sources are compiled in place, objects go to $BUILD_DIR.
#
# Usage: FLOWONTHEGO_REFERENCE=<upstream checkout> build.sh [BUILD_DIR]
#        (default BUILD_DIR: build/kroeger_oracle in this repository)
set -euo pipefail

REF="${FLOWONTHEGO_REFERENCE:?set FLOWONTHEGO_REFERENCE to an upstream FlowOnTheGo checkout}/kroeger"
SHIM="$(cd "$(dirname "$0")" && pwd)/eigen_shim"
BUILD_DIR="${1:-$(cd "$(dirname "$0")/../.." && pwd)/build/kroeger_oracle}"
mkdir -p "$BUILD_DIR"

OPENCV_CFLAGS=$(pkg-config --cflags opencv4)
OPENCV_LIBS=$(pkg-config --libs opencv4)

# Legacy OpenCV 2.x constants used by the reference driver, mapped to the
# modern API so it compiles against OpenCV >= 4.
COMPAT="-DCV_LOAD_IMAGE_COLOR=cv::IMREAD_COLOR -DCV_LOAD_IMAGE_GRAYSCALE=cv::IMREAD_GRAYSCALE"

CXXFLAGS="-O3 -std=c++14 -msse4 -Wno-unknown-pragmas -Wno-unused-result -I$SHIM $OPENCV_CFLAGS $COMPAT"
CFLAGS="-O3 -msse4 -Wno-unknown-pragmas"

CPP_SOURCES="run_dense.cpp oflow.cpp patch.cpp patchgrid.cpp refine_variational.cpp"
C_SOURCES="FDF1.0.1/image.c FDF1.0.1/opticalflow_aux.c FDF1.0.1/solver.c"

build_variant() {
  local name=$1 mode=$2 channel=$3
  local objs=()
  for src in $C_SOURCES; do
    local obj="$BUILD_DIR/$(basename "$src" .c)_${name}.o"
    if [ ! -f "$obj" ] || [ "$REF/$src" -nt "$obj" ]; then
      gcc $CFLAGS -DSELECTMODE=$mode -DSELECTCHANNEL=$channel -c "$REF/$src" -o "$obj"
    fi
    objs+=("$obj")
  done
  for src in $CPP_SOURCES; do
    local obj="$BUILD_DIR/$(basename "$src" .cpp)_${name}.o"
    if [ ! -f "$obj" ] || [ "$REF/$src" -nt "$obj" ]; then
      g++ $CXXFLAGS -DSELECTMODE=$mode -DSELECTCHANNEL=$channel -c "$REF/$src" -o "$obj"
    fi
    objs+=("$obj")
  done
  g++ "${objs[@]}" -o "$BUILD_DIR/$name" $OPENCV_LIBS
  echo "built $BUILD_DIR/$name"
}

# RGB optical flow is the benchmarked configuration; grayscale OF and depth
# variants cover the mode tests.
build_variant run_OF_RGB 1 3
build_variant run_OF_INT 1 1
build_variant run_DE_RGB 2 3
