// geomlib — native geometry runtime (a copy of sv3d_tpu/native/geomlib.cpp,
// built and loaded by sv3d_tpu_torch/native/__init__.py).
//
// TPU-native replacements for the reference's native dependencies
// (SURVEY.md §2 "Native-code components"):
//   * marching cubes  — replaces PyMCubes (reference util/visualize.py:23-25)
//   * triangle hash   — replaces the Cython libmesh extension
//                       (reference data_processing/libmesh/triangle_hash.pyx)
//   * 3-D KD-tree     — replaces pykdtree (reference util/evaluate.py:105-106)
//
// All host-side preprocessing / evaluation work; exposed through a C ABI and
// loaded from Python with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <string>
#include <vector>

extern "C" {

// Interface version handshake: bump whenever an exported signature is added,
// removed, or changed.  The Python loader (sv3d_tpu/native/__init__.py)
// rebuilds the library when the loaded binary reports a different value —
// a pure mtime check misses stale binaries whose timestamps were refreshed
// by a git checkout or file copy.
long geom_abi_version() { return 3; }

// ---------------------------------------------------------------------------
// Marching cubes
// ---------------------------------------------------------------------------

// Standard marching-cubes edge/triangle tables (public domain, after
// Lorensen & Cline 1987 / P. Bourke's polygonise).
static const int kEdgeTable[256] = {
0x0,0x109,0x203,0x30a,0x406,0x50f,0x605,0x70c,0x80c,0x905,0xa0f,0xb06,0xc0a,0xd03,0xe09,0xf00,
0x190,0x99,0x393,0x29a,0x596,0x49f,0x795,0x69c,0x99c,0x895,0xb9f,0xa96,0xd9a,0xc93,0xf99,0xe90,
0x230,0x339,0x33,0x13a,0x636,0x73f,0x435,0x53c,0xa3c,0xb35,0x83f,0x936,0xe3a,0xf33,0xc39,0xd30,
0x3a0,0x2a9,0x1a3,0xaa,0x7a6,0x6af,0x5a5,0x4ac,0xbac,0xaa5,0x9af,0x8a6,0xfaa,0xea3,0xda9,0xca0,
0x460,0x569,0x663,0x76a,0x66,0x16f,0x265,0x36c,0xc6c,0xd65,0xe6f,0xf66,0x86a,0x963,0xa69,0xb60,
0x5f0,0x4f9,0x7f3,0x6fa,0x1f6,0xff,0x3f5,0x2fc,0xdfc,0xcf5,0xfff,0xef6,0x9fa,0x8f3,0xbf9,0xaf0,
0x650,0x759,0x453,0x55a,0x256,0x35f,0x55,0x15c,0xe5c,0xf55,0xc5f,0xd56,0xa5a,0xb53,0x859,0x950,
0x7c0,0x6c9,0x5c3,0x4ca,0x3c6,0x2cf,0x1c5,0xcc,0xfcc,0xec5,0xdcf,0xcc6,0xbca,0xac3,0x9c9,0x8c0,
0x8c0,0x9c9,0xac3,0xbca,0xcc6,0xdcf,0xec5,0xfcc,0xcc,0x1c5,0x2cf,0x3c6,0x4ca,0x5c3,0x6c9,0x7c0,
0x950,0x859,0xb53,0xa5a,0xd56,0xc5f,0xf55,0xe5c,0x15c,0x55,0x35f,0x256,0x55a,0x453,0x759,0x650,
0xaf0,0xbf9,0x8f3,0x9fa,0xef6,0xfff,0xcf5,0xdfc,0x2fc,0x3f5,0xff,0x1f6,0x6fa,0x7f3,0x4f9,0x5f0,
0xb60,0xa69,0x963,0x86a,0xf66,0xe6f,0xd65,0xc6c,0x36c,0x265,0x16f,0x66,0x76a,0x663,0x569,0x460,
0xca0,0xda9,0xea3,0xfaa,0x8a6,0x9af,0xaa5,0xbac,0x4ac,0x5a5,0x6af,0x7a6,0xaa,0x1a3,0x2a9,0x3a0,
0xd30,0xc39,0xf33,0xe3a,0x936,0x83f,0xb35,0xa3c,0x53c,0x435,0x73f,0x636,0x13a,0x33,0x339,0x230,
0xe90,0xf99,0xc93,0xd9a,0xa96,0xb9f,0x895,0x99c,0x69c,0x795,0x49f,0x596,0x29a,0x393,0x99,0x190,
0xf00,0xe09,0xd03,0xc0a,0xb06,0xa0f,0x905,0x80c,0x70c,0x605,0x50f,0x406,0x30a,0x203,0x109,0x0};

static const signed char kTriTable[256][16] = {
{-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,8,3,9,8,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,1,2,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,2,10,0,2,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,8,3,2,10,8,10,9,8,-1,-1,-1,-1,-1,-1,-1},
{3,11,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,11,2,8,11,0,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,2,3,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,11,2,1,9,11,9,8,11,-1,-1,-1,-1,-1,-1,-1},
{3,10,1,11,10,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,10,1,0,8,10,8,11,10,-1,-1,-1,-1,-1,-1,-1},
{3,9,0,3,11,9,11,10,9,-1,-1,-1,-1,-1,-1,-1},
{9,8,10,10,8,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,7,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,3,0,7,3,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,8,4,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,1,9,4,7,1,7,3,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,8,4,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,4,7,3,0,4,1,2,10,-1,-1,-1,-1,-1,-1,-1},
{9,2,10,9,0,2,8,4,7,-1,-1,-1,-1,-1,-1,-1},
{2,10,9,2,9,7,2,7,3,7,9,4,-1,-1,-1,-1},
{8,4,7,3,11,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,4,7,11,2,4,2,0,4,-1,-1,-1,-1,-1,-1,-1},
{9,0,1,8,4,7,2,3,11,-1,-1,-1,-1,-1,-1,-1},
{4,7,11,9,4,11,9,11,2,9,2,1,-1,-1,-1,-1},
{3,10,1,3,11,10,7,8,4,-1,-1,-1,-1,-1,-1,-1},
{1,11,10,1,4,11,1,0,4,7,11,4,-1,-1,-1,-1},
{4,7,8,9,0,11,9,11,10,11,0,3,-1,-1,-1,-1},
{4,7,11,4,11,9,9,11,10,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,0,8,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,5,4,1,5,0,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,5,4,8,3,5,3,1,5,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,9,5,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,1,2,10,4,9,5,-1,-1,-1,-1,-1,-1,-1},
{5,2,10,5,4,2,4,0,2,-1,-1,-1,-1,-1,-1,-1},
{2,10,5,3,2,5,3,5,4,3,4,8,-1,-1,-1,-1},
{9,5,4,2,3,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,11,2,0,8,11,4,9,5,-1,-1,-1,-1,-1,-1,-1},
{0,5,4,0,1,5,2,3,11,-1,-1,-1,-1,-1,-1,-1},
{2,1,5,2,5,8,2,8,11,4,8,5,-1,-1,-1,-1},
{10,3,11,10,1,3,9,5,4,-1,-1,-1,-1,-1,-1,-1},
{4,9,5,0,8,1,8,10,1,8,11,10,-1,-1,-1,-1},
{5,4,0,5,0,11,5,11,10,11,0,3,-1,-1,-1,-1},
{5,4,8,5,8,10,10,8,11,-1,-1,-1,-1,-1,-1,-1},
{9,7,8,5,7,9,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,3,0,9,5,3,5,7,3,-1,-1,-1,-1,-1,-1,-1},
{0,7,8,0,1,7,1,5,7,-1,-1,-1,-1,-1,-1,-1},
{1,5,3,3,5,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,7,8,9,5,7,10,1,2,-1,-1,-1,-1,-1,-1,-1},
{10,1,2,9,5,0,5,3,0,5,7,3,-1,-1,-1,-1},
{8,0,2,8,2,5,8,5,7,10,5,2,-1,-1,-1,-1},
{2,10,5,2,5,3,3,5,7,-1,-1,-1,-1,-1,-1,-1},
{7,9,5,7,8,9,3,11,2,-1,-1,-1,-1,-1,-1,-1},
{9,5,7,9,7,2,9,2,0,2,7,11,-1,-1,-1,-1},
{2,3,11,0,1,8,1,7,8,1,5,7,-1,-1,-1,-1},
{11,2,1,11,1,7,7,1,5,-1,-1,-1,-1,-1,-1,-1},
{9,5,8,8,5,7,10,1,3,10,3,11,-1,-1,-1,-1},
{5,7,0,5,0,9,7,11,0,1,0,10,11,10,0,-1},
{11,10,0,11,0,3,10,5,0,8,0,7,5,7,0,-1},
{11,10,5,7,11,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{10,6,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,5,10,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,0,1,5,10,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,8,3,1,9,8,5,10,6,-1,-1,-1,-1,-1,-1,-1},
{1,6,5,2,6,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,6,5,1,2,6,3,0,8,-1,-1,-1,-1,-1,-1,-1},
{9,6,5,9,0,6,0,2,6,-1,-1,-1,-1,-1,-1,-1},
{5,9,8,5,8,2,5,2,6,3,2,8,-1,-1,-1,-1},
{2,3,11,10,6,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,0,8,11,2,0,10,6,5,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,2,3,11,5,10,6,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,1,9,2,9,11,2,9,8,11,-1,-1,-1,-1},
{6,3,11,6,5,3,5,1,3,-1,-1,-1,-1,-1,-1,-1},
{0,8,11,0,11,5,0,5,1,5,11,6,-1,-1,-1,-1},
{3,11,6,0,3,6,0,6,5,0,5,9,-1,-1,-1,-1},
{6,5,9,6,9,11,11,9,8,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,4,7,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,3,0,4,7,3,6,5,10,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,5,10,6,8,4,7,-1,-1,-1,-1,-1,-1,-1},
{10,6,5,1,9,7,1,7,3,7,9,4,-1,-1,-1,-1},
{6,1,2,6,5,1,4,7,8,-1,-1,-1,-1,-1,-1,-1},
{1,2,5,5,2,6,3,0,4,3,4,7,-1,-1,-1,-1},
{8,4,7,9,0,5,0,6,5,0,2,6,-1,-1,-1,-1},
{7,3,9,7,9,4,3,2,9,5,9,6,2,6,9,-1},
{3,11,2,7,8,4,10,6,5,-1,-1,-1,-1,-1,-1,-1},
{5,10,6,4,7,2,4,2,0,2,7,11,-1,-1,-1,-1},
{0,1,9,4,7,8,2,3,11,5,10,6,-1,-1,-1,-1},
{9,2,1,9,11,2,9,4,11,7,11,4,5,10,6,-1},
{8,4,7,3,11,5,3,5,1,5,11,6,-1,-1,-1,-1},
{5,1,11,5,11,6,1,0,11,7,11,4,0,4,11,-1},
{0,5,9,0,6,5,0,3,6,11,6,3,8,4,7,-1},
{6,5,9,6,9,11,4,7,9,7,11,9,-1,-1,-1,-1},
{10,4,9,6,4,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,10,6,4,9,10,0,8,3,-1,-1,-1,-1,-1,-1,-1},
{10,0,1,10,6,0,6,4,0,-1,-1,-1,-1,-1,-1,-1},
{8,3,1,8,1,6,8,6,4,6,1,10,-1,-1,-1,-1},
{1,4,9,1,2,4,2,6,4,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,1,2,9,2,4,9,2,6,4,-1,-1,-1,-1},
{0,2,4,4,2,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,3,2,8,2,4,4,2,6,-1,-1,-1,-1,-1,-1,-1},
{10,4,9,10,6,4,11,2,3,-1,-1,-1,-1,-1,-1,-1},
{0,8,2,2,8,11,4,9,10,4,10,6,-1,-1,-1,-1},
{3,11,2,0,1,6,0,6,4,6,1,10,-1,-1,-1,-1},
{6,4,1,6,1,10,4,8,1,2,1,11,8,11,1,-1},
{9,6,4,9,3,6,9,1,3,11,6,3,-1,-1,-1,-1},
{8,11,1,8,1,0,11,6,1,9,1,4,6,4,1,-1},
{3,11,6,3,6,0,0,6,4,-1,-1,-1,-1,-1,-1,-1},
{6,4,8,11,6,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,10,6,7,8,10,8,9,10,-1,-1,-1,-1,-1,-1,-1},
{0,7,3,0,10,7,0,9,10,6,7,10,-1,-1,-1,-1},
{10,6,7,1,10,7,1,7,8,1,8,0,-1,-1,-1,-1},
{10,6,7,10,7,1,1,7,3,-1,-1,-1,-1,-1,-1,-1},
{1,2,6,1,6,8,1,8,9,8,6,7,-1,-1,-1,-1},
{2,6,9,2,9,1,6,7,9,0,9,3,7,3,9,-1},
{7,8,0,7,0,6,6,0,2,-1,-1,-1,-1,-1,-1,-1},
{7,3,2,6,7,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,11,10,6,8,10,8,9,8,6,7,-1,-1,-1,-1},
{2,0,7,2,7,11,0,9,7,6,7,10,9,10,7,-1},
{1,8,0,1,7,8,1,10,7,6,7,10,2,3,11,-1},
{11,2,1,11,1,7,10,6,1,6,7,1,-1,-1,-1,-1},
{8,9,6,8,6,7,9,1,6,11,6,3,1,3,6,-1},
{0,9,1,11,6,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,8,0,7,0,6,3,11,0,11,6,0,-1,-1,-1,-1},
{7,11,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,6,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,8,11,7,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,1,9,11,7,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,1,9,8,3,1,11,7,6,-1,-1,-1,-1,-1,-1,-1},
{10,1,2,6,11,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,3,0,8,6,11,7,-1,-1,-1,-1,-1,-1,-1},
{2,9,0,2,10,9,6,11,7,-1,-1,-1,-1,-1,-1,-1},
{6,11,7,2,10,3,10,8,3,10,9,8,-1,-1,-1,-1},
{7,2,3,6,2,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{7,0,8,7,6,0,6,2,0,-1,-1,-1,-1,-1,-1,-1},
{2,7,6,2,3,7,0,1,9,-1,-1,-1,-1,-1,-1,-1},
{1,6,2,1,8,6,1,9,8,8,7,6,-1,-1,-1,-1},
{10,7,6,10,1,7,1,3,7,-1,-1,-1,-1,-1,-1,-1},
{10,7,6,1,7,10,1,8,7,1,0,8,-1,-1,-1,-1},
{0,3,7,0,7,10,0,10,9,6,10,7,-1,-1,-1,-1},
{7,6,10,7,10,8,8,10,9,-1,-1,-1,-1,-1,-1,-1},
{6,8,4,11,8,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,6,11,3,0,6,0,4,6,-1,-1,-1,-1,-1,-1,-1},
{8,6,11,8,4,6,9,0,1,-1,-1,-1,-1,-1,-1,-1},
{9,4,6,9,6,3,9,3,1,11,3,6,-1,-1,-1,-1},
{6,8,4,6,11,8,2,10,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,3,0,11,0,6,11,0,4,6,-1,-1,-1,-1},
{4,11,8,4,6,11,0,2,9,2,10,9,-1,-1,-1,-1},
{10,9,3,10,3,2,9,4,3,11,3,6,4,6,3,-1},
{8,2,3,8,4,2,4,6,2,-1,-1,-1,-1,-1,-1,-1},
{0,4,2,4,6,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,9,0,2,3,4,2,4,6,4,3,8,-1,-1,-1,-1},
{1,9,4,1,4,2,2,4,6,-1,-1,-1,-1,-1,-1,-1},
{8,1,3,8,6,1,8,4,6,6,10,1,-1,-1,-1,-1},
{10,1,0,10,0,6,6,0,4,-1,-1,-1,-1,-1,-1,-1},
{4,6,3,4,3,8,6,10,3,0,3,9,10,9,3,-1},
{10,9,4,6,10,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,9,5,7,6,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,4,9,5,11,7,6,-1,-1,-1,-1,-1,-1,-1},
{5,0,1,5,4,0,7,6,11,-1,-1,-1,-1,-1,-1,-1},
{11,7,6,8,3,4,3,5,4,3,1,5,-1,-1,-1,-1},
{9,5,4,10,1,2,7,6,11,-1,-1,-1,-1,-1,-1,-1},
{6,11,7,1,2,10,0,8,3,4,9,5,-1,-1,-1,-1},
{7,6,11,5,4,10,4,2,10,4,0,2,-1,-1,-1,-1},
{3,4,8,3,5,4,3,2,5,10,5,2,11,7,6,-1},
{7,2,3,7,6,2,5,4,9,-1,-1,-1,-1,-1,-1,-1},
{9,5,4,0,8,6,0,6,2,6,8,7,-1,-1,-1,-1},
{3,6,2,3,7,6,1,5,0,5,4,0,-1,-1,-1,-1},
{6,2,8,6,8,7,2,1,8,4,8,5,1,5,8,-1},
{9,5,4,10,1,6,1,7,6,1,3,7,-1,-1,-1,-1},
{1,6,10,1,7,6,1,0,7,8,7,0,9,5,4,-1},
{4,0,10,4,10,5,0,3,10,6,10,7,3,7,10,-1},
{7,6,10,7,10,8,5,4,10,4,8,10,-1,-1,-1,-1},
{6,9,5,6,11,9,11,8,9,-1,-1,-1,-1,-1,-1,-1},
{3,6,11,0,6,3,0,5,6,0,9,5,-1,-1,-1,-1},
{0,11,8,0,5,11,0,1,5,5,6,11,-1,-1,-1,-1},
{6,11,3,6,3,5,5,3,1,-1,-1,-1,-1,-1,-1,-1},
{1,2,10,9,5,11,9,11,8,11,5,6,-1,-1,-1,-1},
{0,11,3,0,6,11,0,9,6,5,6,9,1,2,10,-1},
{11,8,5,11,5,6,8,0,5,10,5,2,0,2,5,-1},
{6,11,3,6,3,5,2,10,3,10,5,3,-1,-1,-1,-1},
{5,8,9,5,2,8,5,6,2,3,8,2,-1,-1,-1,-1},
{9,5,6,9,6,0,0,6,2,-1,-1,-1,-1,-1,-1,-1},
{1,5,8,1,8,0,5,6,8,3,8,2,6,2,8,-1},
{1,5,6,2,1,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,3,6,1,6,10,3,8,6,5,6,9,8,9,6,-1},
{10,1,0,10,0,6,9,5,0,5,6,0,-1,-1,-1,-1},
{0,3,8,5,6,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{10,5,6,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,5,10,7,5,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{11,5,10,11,7,5,8,3,0,-1,-1,-1,-1,-1,-1,-1},
{5,11,7,5,10,11,1,9,0,-1,-1,-1,-1,-1,-1,-1},
{10,7,5,10,11,7,9,8,1,8,3,1,-1,-1,-1,-1},
{11,1,2,11,7,1,7,5,1,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,1,2,7,1,7,5,7,2,11,-1,-1,-1,-1},
{9,7,5,9,2,7,9,0,2,2,11,7,-1,-1,-1,-1},
{7,5,2,7,2,11,5,9,2,3,2,8,9,8,2,-1},
{2,5,10,2,3,5,3,7,5,-1,-1,-1,-1,-1,-1,-1},
{8,2,0,8,5,2,8,7,5,10,2,5,-1,-1,-1,-1},
{9,0,1,5,10,3,5,3,7,3,10,2,-1,-1,-1,-1},
{9,8,2,9,2,1,8,7,2,10,2,5,7,5,2,-1},
{1,3,5,3,7,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,8,7,0,7,1,1,7,5,-1,-1,-1,-1,-1,-1,-1},
{9,0,3,9,3,5,5,3,7,-1,-1,-1,-1,-1,-1,-1},
{9,8,7,5,9,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{5,8,4,5,10,8,10,11,8,-1,-1,-1,-1,-1,-1,-1},
{5,0,4,5,11,0,5,10,11,11,3,0,-1,-1,-1,-1},
{0,1,9,8,4,10,8,10,11,10,4,5,-1,-1,-1,-1},
{10,11,4,10,4,5,11,3,4,9,4,1,3,1,4,-1},
{2,5,1,2,8,5,2,11,8,4,5,8,-1,-1,-1,-1},
{0,4,11,0,11,3,4,5,11,2,11,1,5,1,11,-1},
{0,2,5,0,5,9,2,11,5,4,5,8,11,8,5,-1},
{9,4,5,2,11,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,5,10,3,5,2,3,4,5,3,8,4,-1,-1,-1,-1},
{5,10,2,5,2,4,4,2,0,-1,-1,-1,-1,-1,-1,-1},
{3,10,2,3,5,10,3,8,5,4,5,8,0,1,9,-1},
{5,10,2,5,2,4,1,9,2,9,4,2,-1,-1,-1,-1},
{8,4,5,8,5,3,3,5,1,-1,-1,-1,-1,-1,-1,-1},
{0,4,5,1,0,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{8,4,5,8,5,3,9,0,5,0,3,5,-1,-1,-1,-1},
{9,4,5,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,11,7,4,9,11,9,10,11,-1,-1,-1,-1,-1,-1,-1},
{0,8,3,4,9,7,9,11,7,9,10,11,-1,-1,-1,-1},
{1,10,11,1,11,4,1,4,0,7,4,11,-1,-1,-1,-1},
{3,1,4,3,4,8,1,10,4,7,4,11,10,11,4,-1},
{4,11,7,9,11,4,9,2,11,9,1,2,-1,-1,-1,-1},
{9,7,4,9,11,7,9,1,11,2,11,1,0,8,3,-1},
{11,7,4,11,4,2,2,4,0,-1,-1,-1,-1,-1,-1,-1},
{11,7,4,11,4,2,8,3,4,3,2,4,-1,-1,-1,-1},
{2,9,10,2,7,9,2,3,7,7,4,9,-1,-1,-1,-1},
{9,10,7,9,7,4,10,2,7,8,7,0,2,0,7,-1},
{3,7,10,3,10,2,7,4,10,1,10,0,4,0,10,-1},
{1,10,2,8,7,4,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,9,1,4,1,7,7,1,3,-1,-1,-1,-1,-1,-1,-1},
{4,9,1,4,1,7,0,8,1,8,7,1,-1,-1,-1,-1},
{4,0,3,7,4,3,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{4,8,7,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{9,10,8,10,11,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,0,9,3,9,11,11,9,10,-1,-1,-1,-1,-1,-1,-1},
{0,1,10,0,10,8,8,10,11,-1,-1,-1,-1,-1,-1,-1},
{3,1,10,11,3,10,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,2,11,1,11,9,9,11,8,-1,-1,-1,-1,-1,-1,-1},
{3,0,9,3,9,11,1,2,9,2,11,9,-1,-1,-1,-1},
{0,2,11,8,0,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{3,2,11,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,8,2,8,10,10,8,9,-1,-1,-1,-1,-1,-1,-1},
{9,10,2,0,9,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{2,3,8,2,8,10,0,1,8,1,10,8,-1,-1,-1,-1},
{1,10,2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{1,3,8,9,1,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,9,1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{0,3,8,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1},
{-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1,-1}};

// cube corner offsets (x, y, z) and the edges' endpoint corner pairs
static const int kCorner[8][3] = {
    {0,0,0},{1,0,0},{1,1,0},{0,1,0},{0,0,1},{1,0,1},{1,1,1},{0,1,1}};
static const int kEdgeCorners[12][2] = {
    {0,1},{1,2},{2,3},{3,0},{4,5},{5,6},{6,7},{7,4},{0,4},{1,5},{2,6},{3,7}};

typedef struct {
  float* verts;   // (n_verts, 3)
  int64_t n_verts;
  int32_t* tris;  // (n_tris, 3)
  int64_t n_tris;
} McResult;

}  // extern "C" — resumed after mc_run_impl (templates cannot have C linkage)

// Marching-cubes core over element type T with a compile-time inside-test
// direction.  GT=false: a corner is inside when value < level (the float
// API).  GT=true: inside when value > level — used by the u8 fixed-point
// serving pull, which maps "isosurface of (1 - v/255) at p" into the RAW
// u8 domain as level = 255*(1-p): the inside test flips to v > level and
// the edge interpolation t = (level - v0)/(v1 - v0) is invariant under the
// affine remap, so the mesh matches the float path to float rounding
// without ever materializing a float copy of the volume (two 52 MB host
// passes saved on the full-scale 12.95M-cell serving grid).
template <typename T, bool GT>
static McResult* mc_run_impl(const T* vol, int nx, int ny, int nz, float level) {
  auto at = [&](int x, int y, int z) -> float {
    return (float)vol[((int64_t)x * ny + y) * nz + z];
  };
  auto inside = [&](float v) { return GT ? (v > level) : (v < level); };
  std::vector<float> verts;
  std::vector<int32_t> tris;
  // edge-vertex dedup: key = (cell linear idx) * 12 + edge, but shared edges
  // between cells have different keys; use a canonical key based on the edge's
  // lower corner and axis instead.
  // canonical edge id: vertex lies on an axis-aligned edge from grid point
  // (x, y, z) along axis a -> key = ((x*ny + y)*nz + z) * 3 + a
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  // use open addressing hash map for speed
  struct Hash {
    std::vector<std::pair<int64_t, int32_t>> table;
    size_t mask;
    size_t used = 0;
    Hash(size_t n) {
      size_t cap = 64;
      while (cap < n * 2) cap <<= 1;
      table.assign(cap, {-1, -1});
      mask = cap - 1;
    }
    void grow() {
      std::vector<std::pair<int64_t, int32_t>> old;
      old.swap(table);
      table.assign(old.size() * 2, {-1, -1});
      mask = table.size() - 1;
      for (auto& kv : old) {
        if (kv.first == -1) continue;
        size_t h = (size_t)(kv.first * 0x9E3779B97F4A7C15ULL) & mask;
        while (table[h].first != -1) h = (h + 1) & mask;
        table[h] = kv;
      }
    }
    int32_t* find_or_insert(int64_t key) {
      if (used * 4 >= table.size() * 3) grow();  // keep load factor < 0.75
      size_t h = (size_t)(key * 0x9E3779B97F4A7C15ULL) & mask;
      while (true) {
        auto& slot = table[h];
        if (slot.first == key) return &slot.second;
        if (slot.first == -1) {
          slot.first = key;
          slot.second = -1;
          used++;
          return &slot.second;
        }
        h = (h + 1) & mask;
      }
    }
  };
  Hash edge_map((size_t)nx * ny * 2);

  // Pass 1: per-(x, y) grid row, pack (vol < level) into 64-bit masks.  The
  // naive cell loop reads 8 scattered corners for all nx*ny*nz cells; on a
  // 278x208x224 sweep that is ~100M reads and ~8 s.  Surface cells are ~1% of
  // the volume, so a cheap sign prepass + word-parallel uniformity test makes
  // the expensive per-cell body run only where the isosurface actually is.
  const int nw = (nz + 63) >> 6;
  std::vector<uint64_t> bits((size_t)nx * ny * nw, 0);
  for (int x = 0; x < nx; ++x) {
    for (int y = 0; y < ny; ++y) {
      const T* row = vol + ((int64_t)x * ny + y) * nz;
      uint64_t* b = &bits[((size_t)x * ny + y) * nw];
      for (int z = 0; z < nz; ++z)
        if (inside((float)row[z])) b[z >> 6] |= 1ull << (z & 63);
    }
  }

  float corner_val[8];
  int32_t edge_vert[12];
  for (int x = 0; x < nx - 1; ++x) {
    for (int y = 0; y < ny - 1; ++y) {
      // Pass 2: a cell (x, y, z) is uniform (skippable) iff all 8 corner
      // signs agree.  Combine the 4 involved rows word-wise: u = AND, o = OR;
      // all-inside(z) = u(z) & u(z+1), all-outside(z) = ~o(z) & ~o(z+1).
      const uint64_t* b00 = &bits[((size_t)x * ny + y) * nw];
      const uint64_t* b01 = &bits[((size_t)x * ny + y + 1) * nw];
      const uint64_t* b10 = &bits[((size_t)(x + 1) * ny + y) * nw];
      const uint64_t* b11 = &bits[((size_t)(x + 1) * ny + y + 1) * nw];
      for (int w = 0; w < nw; ++w) {
        uint64_t u = b00[w] & b01[w] & b10[w] & b11[w];
        uint64_t o = b00[w] | b01[w] | b10[w] | b11[w];
        uint64_t u_hi = (w + 1 < nw) ? (b00[w + 1] & b01[w + 1] & b10[w + 1] & b11[w + 1]) : 0;
        uint64_t o_hi = (w + 1 < nw) ? (b00[w + 1] | b01[w + 1] | b10[w + 1] | b11[w + 1]) : 0;
        uint64_t u_next = (u >> 1) | (u_hi << 63);
        uint64_t o_next = (o >> 1) | (o_hi << 63);
        uint64_t all_in = u & u_next;
        uint64_t all_out = ~o & ~o_next;
        uint64_t active = ~(all_in | all_out);
        // clamp to valid cell range z < nz - 1 within this word
        int base = w << 6;
        int zmax = nz - 1 - base;  // cells valid for z-bit < zmax
        if (zmax <= 0) break;
        if (zmax < 64) active &= (1ull << zmax) - 1ull;
        while (active) {
          int zb = __builtin_ctzll(active);
          active &= active - 1;
          int z = base + zb;
        int cubeindex = 0;
        for (int c = 0; c < 8; ++c) {
          corner_val[c] = at(x + kCorner[c][0], y + kCorner[c][1], z + kCorner[c][2]);
          if (inside(corner_val[c])) cubeindex |= (1 << c);
        }
        int em = kEdgeTable[cubeindex];
        if (em == 0) continue;
        for (int e = 0; e < 12; ++e) {
          if (!(em & (1 << e))) continue;
          int c0 = kEdgeCorners[e][0], c1 = kEdgeCorners[e][1];
          int p0[3] = {x + kCorner[c0][0], y + kCorner[c0][1], z + kCorner[c0][2]};
          int p1[3] = {x + kCorner[c1][0], y + kCorner[c1][1], z + kCorner[c1][2]};
          // canonical: lower corner + axis
          int axis = (p0[0] != p1[0]) ? 0 : (p0[1] != p1[1]) ? 1 : 2;
          int lx = std::min(p0[0], p1[0]);
          int ly = std::min(p0[1], p1[1]);
          int lz = std::min(p0[2], p1[2]);
          int64_t key = (((int64_t)lx * ny + ly) * nz + lz) * 3 + axis;
          int32_t* slot = edge_map.find_or_insert(key);
          if (*slot < 0) {
            float v0 = corner_val[c0], v1 = corner_val[c1];
            float t = (std::fabs(v1 - v0) > 1e-12f) ? (level - v0) / (v1 - v0) : 0.5f;
            if (t < 0.f) t = 0.f;
            if (t > 1.f) t = 1.f;
            float vx = p0[0] + t * (p1[0] - p0[0]);
            float vy = p0[1] + t * (p1[1] - p0[1]);
            float vz = p0[2] + t * (p1[2] - p0[2]);
            *slot = (int32_t)(verts.size() / 3);
            verts.push_back(vx);
            verts.push_back(vy);
            verts.push_back(vz);
          }
          edge_vert[e] = *slot;
        }
        const signed char* tt = kTriTable[cubeindex];
        for (int i = 0; tt[i] != -1; i += 3) {
          tris.push_back(edge_vert[(int)tt[i]]);
          tris.push_back(edge_vert[(int)tt[i + 1]]);
          tris.push_back(edge_vert[(int)tt[i + 2]]);
        }
        }  // while (active)
      }
    }
  }
  McResult* res = (McResult*)std::malloc(sizeof(McResult));
  res->n_verts = (int64_t)(verts.size() / 3);
  res->n_tris = (int64_t)(tris.size() / 3);
  res->verts = (float*)std::malloc(verts.size() * sizeof(float));
  res->tris = (int32_t*)std::malloc(tris.size() * sizeof(int32_t));
  std::memcpy(res->verts, verts.data(), verts.size() * sizeof(float));
  std::memcpy(res->tris, tris.data(), tris.size() * sizeof(int32_t));
  return res;
}

extern "C" {

// vol is C-ordered (nx, ny, nz); vertices come back in voxel-index coords.
McResult* mc_run(const float* vol, int nx, int ny, int nz, float level) {
  return mc_run_impl<float, false>(vol, nx, ny, nz, level);
}

// u8 fixed-point serving pull: the isosurface of (1 - vol/255.0) at `level`,
// computed directly on the uint8 grid (see mc_run_impl's remap note).
McResult* mc_run_u8i(const uint8_t* vol, int nx, int ny, int nz, float level) {
  return mc_run_impl<uint8_t, true>(vol, nx, ny, nz, 255.0f * (1.0f - level));
}

void mc_free(McResult* res) {
  if (!res) return;
  std::free(res->verts);
  std::free(res->tris);
  std::free(res);
}

// ---------------------------------------------------------------------------
// 2-D triangle spatial hash (reference triangle_hash.pyx:9-86 equivalent)
// ---------------------------------------------------------------------------

struct TriangleHash {
  std::vector<std::vector<int32_t>> buckets;
  int resolution;
};

// tris2d: (n_tri, 3, 2) float64 triangle xy coordinates
void* th_build(const double* tris2d, int64_t n_tri, int resolution) {
  TriangleHash* h = new TriangleHash();
  h->resolution = resolution;
  h->buckets.resize((size_t)resolution * resolution);
  for (int64_t t = 0; t < n_tri; ++t) {
    const double* tri = tris2d + t * 6;
    // bucket every cell the triangle's bbox overlaps (triangle_hash.pyx:29-47)
    int xlo = (int)std::min(std::min(tri[0], tri[2]), tri[4]);
    int xhi = (int)std::max(std::max(tri[0], tri[2]), tri[4]);
    int ylo = (int)std::min(std::min(tri[1], tri[3]), tri[5]);
    int yhi = (int)std::max(std::max(tri[1], tri[3]), tri[5]);
    xlo = std::min(std::max(xlo, 0), resolution - 1);
    xhi = std::min(std::max(xhi, 0), resolution - 1);
    ylo = std::min(std::max(ylo, 0), resolution - 1);
    yhi = std::min(std::max(yhi, 0), resolution - 1);
    for (int x = xlo; x <= xhi; ++x)
      for (int y = ylo; y <= yhi; ++y)
        h->buckets[(size_t)resolution * x + y].push_back((int32_t)t);
  }
  return h;
}

typedef struct {
  int32_t* point_idx;
  int32_t* tri_idx;
  int64_t n;
} ThResult;

// points: (n_pts, 2) float64 -> all (point, candidate triangle) pairs
ThResult* th_query(void* handle, const double* points, int64_t n_pts) {
  TriangleHash* h = (TriangleHash*)handle;
  std::vector<int32_t> pi, ti;
  for (int64_t p = 0; p < n_pts; ++p) {
    int x = (int)points[p * 2];
    int y = (int)points[p * 2 + 1];
    if (x < 0 || x >= h->resolution || y < 0 || y >= h->resolution) continue;
    for (int32_t t : h->buckets[(size_t)h->resolution * x + y]) {
      pi.push_back((int32_t)p);
      ti.push_back(t);
    }
  }
  ThResult* res = (ThResult*)std::malloc(sizeof(ThResult));
  res->n = (int64_t)pi.size();
  res->point_idx = (int32_t*)std::malloc(pi.size() * sizeof(int32_t));
  res->tri_idx = (int32_t*)std::malloc(ti.size() * sizeof(int32_t));
  std::memcpy(res->point_idx, pi.data(), pi.size() * sizeof(int32_t));
  std::memcpy(res->tri_idx, ti.data(), ti.size() * sizeof(int32_t));
  return res;
}

void th_free_result(ThResult* res) {
  if (!res) return;
  std::free(res->point_idx);
  std::free(res->tri_idx);
  std::free(res);
}

void th_free(void* handle) { delete (TriangleHash*)handle; }

// ---------------------------------------------------------------------------
// 3-D KD-tree nearest neighbour (pykdtree equivalent for Chamfer eval)
// ---------------------------------------------------------------------------

struct KdTree {
  // implicit balanced tree over a permutation of point indices
  std::vector<float> pts;      // (n, 3)
  std::vector<int64_t> order;  // permutation, tree in nodes [lo, hi)
  int64_t n;

  void build(int64_t lo, int64_t hi, int depth) {
    if (hi - lo <= 1) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    std::nth_element(
        order.begin() + lo, order.begin() + mid, order.begin() + hi,
        [&](int64_t a, int64_t b) { return pts[a * 3 + axis] < pts[b * 3 + axis]; });
    build(lo, mid, depth + 1);
    build(mid + 1, hi, depth + 1);
  }

  void query(const float* q, int64_t lo, int64_t hi, int depth,
             float* best_d2, int64_t* best_i) const {
    if (hi <= lo) return;
    int axis = depth % 3;
    int64_t mid = (lo + hi) / 2;
    int64_t idx = order[mid];
    const float* p = &pts[idx * 3];
    float d2 = 0;
    for (int k = 0; k < 3; ++k) {
      float d = q[k] - p[k];
      d2 += d * d;
    }
    if (d2 < *best_d2) {
      *best_d2 = d2;
      *best_i = idx;
    }
    float delta = q[axis] - p[axis];
    if (delta < 0) {
      query(q, lo, mid, depth + 1, best_d2, best_i);
      if (delta * delta < *best_d2) query(q, mid + 1, hi, depth + 1, best_d2, best_i);
    } else {
      query(q, mid + 1, hi, depth + 1, best_d2, best_i);
      if (delta * delta < *best_d2) query(q, lo, mid, depth + 1, best_d2, best_i);
    }
  }
};

void* kd_build(const float* pts, int64_t n) {
  KdTree* t = new KdTree();
  t->n = n;
  t->pts.assign(pts, pts + n * 3);
  t->order.resize(n);
  for (int64_t i = 0; i < n; ++i) t->order[i] = i;
  t->build(0, n, 0);
  return t;
}

void kd_query(void* handle, const float* queries, int64_t nq,
              float* out_dist, int64_t* out_idx) {
  KdTree* t = (KdTree*)handle;
  for (int64_t i = 0; i < nq; ++i) {
    float best_d2 = INFINITY;
    int64_t best_i = -1;
    t->query(queries + i * 3, 0, t->n, 0, &best_d2, &best_i);
    out_dist[i] = std::sqrt(best_d2);
    out_idx[i] = best_i;
  }
}

void kd_free(void* handle) { delete (KdTree*)handle; }

// ---------------------------------------------------------------------------
// OBJ text serialization
// ---------------------------------------------------------------------------
// The serving path ends in an .obj dump (visualize_sdf -> save_obj); the
// per-line Python formatter measured ~0.39 s on a 57k-vert/115k-tri
// full-scale scene mesh — a quarter of the warm image->mesh latency.  This
// emits the identical text ("v %.8g %.8g %.8g" / 1-based "f %d %d %d" lines,
// matching Python's f"{x:.8g}" shortest-round-trip-of-8-significant-digits)
// in one pass.  verts are double so Python float32/float64 inputs format
// exactly like the Python formatter (which also prints via double).

// Returns a malloc'd text buffer (length in *out_len, no trailing NUL
// guarantee beyond *out_len bytes); free with obj_free.
char* obj_format(const double* verts, int64_t n_verts,
                 const int32_t* tris, int64_t n_tris, int64_t* out_len) {
  std::string out;
  out.reserve((size_t)n_verts * 40 + (size_t)n_tris * 27 + 64);
  char line[96];
  for (int64_t i = 0; i < n_verts; ++i) {
    const double* v = verts + i * 3;
    int n = snprintf(line, sizeof line, "v %.8g %.8g %.8g\n", v[0], v[1], v[2]);
    out.append(line, (size_t)n);
  }
  for (int64_t i = 0; i < n_tris; ++i) {
    const int32_t* t = tris + i * 3;
    int n = snprintf(line, sizeof line, "f %d %d %d\n", t[0] + 1, t[1] + 1,
                     t[2] + 1);
    out.append(line, (size_t)n);
  }
  char* buf = (char*)std::malloc(out.size() ? out.size() : 1);
  std::memcpy(buf, out.data(), out.size());
  *out_len = (int64_t)out.size();
  return buf;
}

void obj_free(char* buf) { std::free(buf); }

}  // extern "C"
