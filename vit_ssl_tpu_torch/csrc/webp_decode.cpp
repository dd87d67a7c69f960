// The port's WebP decoder (data/webp.py): the VP8 (lossy, RFC 6386) and VP8L
// (lossless, RFC 9649) bitstreams, with libwebp's arithmetic wherever the
// specification leaves a choice, so the pixels equal what OpenCV
// (WebPDecodeBGRInto) and PIL (WebPAnimDecoder) give. Standard library only,
// a plain C interface for ctypes (data/webp.py) and for the whole-batch
// decode (batch_decode.cpp). The entry reads the RIFF container too: a
// simple lossy (VP8) or lossless (VP8L) file, or an extended one (VP8X)
// whose ALPH chunk is dropped, as IMREAD_COLOR and convert("RGB") drop
// alpha; an animation is refused; the EXIF chunk's orientation
// (host_image.h) is applied when asked for, as OpenCV's reader does.
//
// VP8: the boolean decoder, segments, the token probabilities and their
// updates, the 16x16, 4x4 and chroma intra predictors on libwebp's work
// buffer (127 above the image, 129 left of it, the above-right pixels of a
// macroblock's right column of 4x4 blocks replicated down), the inverse WHT
// and DCT, the simple and normal loop filters applied after the whole frame
// is reconstructed (prediction reads unfiltered samples), then libwebp's
// "fancy" chroma upsampling and its 14-bit fixed-point YUV->RGB.
//
// VP8L: the transforms (predictor, cross colour, subtract green, colour
// indexing with pixel packing), the colour cache, meta prefix codes and
// LZ77 backward references with the distance map.
//
// The entry returns 0 and RGB rows in *out (release with webp_free), 1 for
// an animation or 2 for damaged data, with a message.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "host_image.h"

namespace {

constexpr int kOk = 0, kUnsupported = 1, kInvalid = 2;

struct Failure {
  int status;
  std::string message;
};

[[noreturn]] void fail(int status, const char* fmt, ...) {
  char buf[512];
  va_list args;
  va_start(args, fmt);
  std::vsnprintf(buf, sizeof(buf), fmt, args);
  va_end(args);
  throw Failure{status, buf};
}

// ------------------------------------------------------------------ tables
// RFC 6386's constants, in libwebp's order of the 4x4 modes (DC, TM, VE, HE,
// RD, VR, LD, VL, HD, HU).
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// the 4x4 mode tree: a non-positive entry is minus a mode
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

inline int clip(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// ------------------------------------------------------- boolean decoder
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  int past = 0;  // bytes read past the end (as zeros)

  void init(const uint8_t* start, size_t size) {
    p = start;
    end = start + size;
    value = (next() << 8) | next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() {
    if (p < end) return *p++;
    ++past;
    return 0;
  }
  int get(int prob) {
    uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  uint32_t literal(int bits) {
    uint32_t v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int bits) {
    int v = static_cast<int>(literal(bits));
    return get(128) ? -v : v;
  }
  int flag_signed(int bits) { return get(128) ? signed_literal(bits) : 0; }
};

// ------------------------------------------------------------ VP8 (lossy)
constexpr int BPS = 32;  // the work buffer's stride, as libwebp's

struct MacroBlock {
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {0};
  int16_t coeffs[384];
  bool nonzero = false;  // any residual coefficient (after the WHT)
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev = 0, inner = 0;
};

struct Vp8 {
  const uint8_t* data;
  size_t size;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = false;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantizers a segment: y1 dc/ac, y2 dc/ac, uv dc/ac
  int dq[4][6];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];
  // planes padded to whole macroblocks
  std::vector<uint8_t> y, u, v;
  int ys = 0, uvs = 0;

  Vp8(const uint8_t* d, size_t n) : data(d), size(n) {}

  void parse_header() {
    if (size < 10) fail(kInvalid, "VP8 frame of %zu bytes is truncated", size);
    uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    bool key_frame = !(bits & 1);
    int profile = (bits >> 1) & 7;
    bool show = (bits >> 4) & 1;
    size_t part_size = bits >> 5;
    if (!key_frame) fail(kInvalid, "VP8 frame is not a key frame");
    if (profile > 3) fail(kInvalid, "VP8 profile %d is invalid", profile);
    if (!show) fail(kInvalid, "VP8 frame is not shown");
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
      fail(kInvalid, "VP8 key frame lacks its start code (byte 3)");
    width = (data[6] | (data[7] << 8)) & 0x3fff;
    height = (data[8] | (data[9] << 8)) & 0x3fff;
    if (width == 0 || height == 0) fail(kInvalid, "VP8 frame size %dx%d is invalid", width, height);
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    size_t left = size - 10;
    if (part_size > left)
      fail(kInvalid, "VP8 first partition of %zu bytes runs past the frame (%zu bytes)",
           part_size, left);
    br.init(buf, part_size);
    buf += part_size;
    left -= part_size;
    br.get(128);  // colour space
    br.get(128);  // clamping type
    // segments
    use_segment = br.get(128);
    if (use_segment) {
      update_map = br.get(128);
      if (br.get(128)) {
        absolute_delta = br.get(128);
        for (int& q : quantizer) q = br.flag_signed(7);
        for (int& f : filter_strength) f = br.flag_signed(6);
      }
      if (update_map)
        for (int& p : seg_probs) p = br.get(128) ? static_cast<int>(br.literal(8)) : 255;
    }
    // loop filter
    simple = br.get(128);
    level = static_cast<int>(br.literal(6));
    sharpness = static_cast<int>(br.literal(3));
    use_lf_delta = br.get(128);
    if (use_lf_delta && br.get(128)) {
      for (int& d : ref_lf_delta)
        if (br.get(128)) d = br.signed_literal(6);
      for (int& d : mode_lf_delta)
        if (br.get(128)) d = br.signed_literal(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // token partitions
    int last = (1 << br.literal(2)) - 1;
    if (left < 3 * static_cast<size_t>(last))
      fail(kInvalid, "VP8 partition sizes run past the frame");
    const uint8_t* sizes = buf;
    const uint8_t* start = buf + 3 * last;
    size_t remaining = left - 3 * last;
    parts.resize(last + 1);
    for (int p = 0; p < last; ++p) {
      size_t psize = sizes[0] | (sizes[1] << 8) | (sizes[2] << 16);
      if (psize > remaining) psize = remaining;
      parts[p].init(start, psize);
      start += psize;
      remaining -= psize;
      sizes += 3;
    }
    parts[last].init(start, remaining);
    if (start >= buf + left) fail(kInvalid, "VP8 last token partition is empty (data cut short)");
    // quantizers
    int base = static_cast<int>(br.literal(7));
    int dy1_dc = br.flag_signed(4), dy2_dc = br.flag_signed(4), dy2_ac = br.flag_signed(4);
    int duv_dc = br.flag_signed(4), duv_ac = br.flag_signed(4);
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s] + (absolute_delta ? 0 : base);
      } else {
        if (s > 0) {
          std::memcpy(dq[s], dq[0], sizeof(dq[0]));
          continue;
        }
        q = base;
      }
      dq[s][0] = kDcTable[clip(q + dy1_dc, 127)];
      dq[s][1] = kAcTable[clip(q, 127)];
      dq[s][2] = kDcTable[clip(q + dy2_dc, 127)] * 2;
      dq[s][3] = (kAcTable[clip(q + dy2_ac, 127)] * 101581) >> 16;
      if (dq[s][3] < 8) dq[s][3] = 8;
      dq[s][4] = kDcTable[clip(q + duv_dc, 117)];
      dq[s][5] = kAcTable[clip(q + duv_ac, 127)];
    }
    br.get(128);  // refresh entropy probabilities (key frames only: ignored)
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.get(kCoeffsUpdateProba[t][b][c][p])
                                    ? static_cast<uint8_t>(br.literal(8))
                                    : kCoeffsProba0[t][b][c][p];
    use_skip = br.get(128);
    if (use_skip) skip_p = static_cast<int>(br.literal(8));
  }

  void filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& info = fstrengths[s][i4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4) lvl += mode_lf_delta[0];
        }
        lvl = clip(lvl, 63);
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4;
      }
    }
  }

  void parse_modes(MacroBlock& mb, uint8_t* top, uint8_t* left) {
    mb.segment = update_map ? (!br.get(seg_probs[0]) ? br.get(seg_probs[1])
                                                     : 2 + br.get(seg_probs[2]))
                            : 0;
    mb.skip = use_skip ? br.get(skip_p) : 0;
    mb.is_i4x4 = !br.get(145);
    if (!mb.is_i4x4) {
      int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED) : (br.get(163) ? V_PRED : DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int yy = 0; yy < 4; ++yy) {
        int ymode = left[yy];
        for (int xx = 0; xx < 4; ++xx) {
          const uint8_t* prob = kBModesProba[top[xx]][ymode];
          int i = kYModesIntra4[br.get(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
          ymode = -i;
          top[xx] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[yy] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolDecoder& b, const uint8_t* p) {
    int v;
    if (!b.get(p[3])) {
      v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
    } else if (!b.get(p[6])) {
      if (!b.get(p[7])) {
        v = 5 + b.get(159);
      } else {
        v = 7 + 2 * b.get(165);
        v += b.get(145);
      }
    } else {
      int bit1 = b.get(p[8]);
      int bit0 = b.get(p[9 + bit1]);
      int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.get(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // the coefficients of one 4x4 block from token position n; returns the
  // position after the last non-zero one
  int coeffs(BoolDecoder& b, int type, int ctx, int dc_q, int ac_q, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.get(p[0])) return n;
      while (!b.get(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!b.get(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = large_value(b, p);
        p = proba[type][kBands[n + 1]][2];
      }
      int s = b.get(128) ? -v : v;
      out[kZigzag[n]] = static_cast<int16_t>(s * (n > 0 ? ac_q : dc_q));
    }
    return 16;
  }

  static void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
      int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      int dc = tmp[0 + i * 4] + 3;
      int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
      out[0] = static_cast<int16_t>((a0 + a1) >> 3);
      out[16] = static_cast<int16_t>((a3 + a2) >> 3);
      out[32] = static_cast<int16_t>((a0 - a1) >> 3);
      out[48] = static_cast<int16_t>((a3 - a2) >> 3);
      out += 64;
    }
  }

  // the residuals of one macroblock; tnz/lnz: the above and left non-zero
  // flags (4 luma, 2 u, 2 v, 1 y2)
  void residuals(BoolDecoder& b, MacroBlock& mb, uint8_t* tnz, uint8_t* lnz) {
    int16_t* dst = mb.coeffs;
    std::memset(dst, 0, sizeof(mb.coeffs));
    const int* q = dq[mb.segment];
    int first, ac_type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      int ctx = tnz[8] + lnz[8];
      int nz = coeffs(b, 1, ctx, q[2], q[3], 0, dc);
      tnz[8] = lnz[8] = nz > 0;
      if (nz > 1) {
        wht(dc, dst);
      } else {
        int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    bool any = false;
    for (int yy = 0; yy < 4; ++yy)
      for (int xx = 0; xx < 4; ++xx) {
        int16_t* block = dst + 16 * (4 * yy + xx);
        int ctx = tnz[xx] + lnz[yy];
        int nz = coeffs(b, ac_type, ctx, q[0], q[1], first, block);
        tnz[xx] = lnz[yy] = nz > first;
        for (int k = 0; k < 16 && !any; ++k) any = block[k] != 0;
      }
    for (int ch = 0; ch < 2; ++ch)
      for (int yy = 0; yy < 2; ++yy)
        for (int xx = 0; xx < 2; ++xx) {
          int16_t* block = dst + 256 + 64 * ch + 16 * (2 * yy + xx);
          int ctx = tnz[4 + 2 * ch + xx] + lnz[4 + 2 * ch + yy];
          int nz = coeffs(b, 2, ctx, q[4], q[5], 0, block);
          tnz[4 + 2 * ch + xx] = lnz[4 + 2 * ch + yy] = nz > 0;
          for (int k = 0; k < 16 && !any; ++k) any = block[k] != 0;
        }
    mb.nonzero = any;
  }

  // ------------------------------------------------ reconstruction
  static inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
  static inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

  static void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    int tl = top[-1];
    for (int yy = 0; yy < size; ++yy) {
      int l = dst[-1];
      for (int xx = 0; xx < size; ++xx) dst[xx] = clip8(top[xx] + l - tl);
      dst += BPS;
    }
  }
  static void fill(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
  }

  static void predict4(uint8_t* dst, int mode) {
#define DST(x, y) dst[(x) + (y) * BPS]
    const uint8_t* top = dst - BPS;
    int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4], F = top[5], G = top[6],
        H = top[7];
    int X = top[-1], I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
        L = dst[-1 + 3 * BPS];
    switch (mode) {
      case B_DC_PRED: {
        uint32_t dc = 4;
        for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, 4, dc >> 3);
        break;
      }
      case B_TM_PRED:
        true_motion(dst, 4);
        break;
      case B_VE_PRED: {
        uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
        for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, vals, 4);
        break;
      }
      case B_HE_PRED:
        std::memset(dst + 0 * BPS, avg3(X, I, J), 4);
        std::memset(dst + 1 * BPS, avg3(I, J, K), 4);
        std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
        std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
        break;
      case B_RD_PRED:
        DST(0, 3) = avg3(J, K, L);
        DST(1, 3) = DST(0, 2) = avg3(I, J, K);
        DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
        DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
        DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
        DST(3, 1) = DST(2, 0) = avg3(C, B, A);
        DST(3, 0) = avg3(D, C, B);
        break;
      case B_LD_PRED:
        DST(0, 0) = avg3(A, B, C);
        DST(1, 0) = DST(0, 1) = avg3(B, C, D);
        DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
        DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
        DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
        DST(3, 2) = DST(2, 3) = avg3(F, G, H);
        DST(3, 3) = avg3(G, H, H);
        break;
      case B_VR_PRED:
        DST(0, 0) = DST(1, 2) = avg2(X, A);
        DST(1, 0) = DST(2, 2) = avg2(A, B);
        DST(2, 0) = DST(3, 2) = avg2(B, C);
        DST(3, 0) = avg2(C, D);
        DST(0, 3) = avg3(K, J, I);
        DST(0, 2) = avg3(J, I, X);
        DST(0, 1) = DST(1, 3) = avg3(I, X, A);
        DST(1, 1) = DST(2, 3) = avg3(X, A, B);
        DST(2, 1) = DST(3, 3) = avg3(A, B, C);
        DST(3, 1) = avg3(B, C, D);
        break;
      case B_VL_PRED:
        DST(0, 0) = avg2(A, B);
        DST(1, 0) = DST(0, 2) = avg2(B, C);
        DST(2, 0) = DST(1, 2) = avg2(C, D);
        DST(3, 0) = DST(2, 2) = avg2(D, E);
        DST(0, 1) = avg3(A, B, C);
        DST(1, 1) = DST(0, 3) = avg3(B, C, D);
        DST(2, 1) = DST(1, 3) = avg3(C, D, E);
        DST(3, 1) = DST(2, 3) = avg3(D, E, F);
        DST(3, 2) = avg3(E, F, G);
        DST(3, 3) = avg3(F, G, H);
        break;
      case B_HD_PRED:
        DST(0, 0) = DST(2, 1) = avg2(I, X);
        DST(0, 1) = DST(2, 2) = avg2(J, I);
        DST(0, 2) = DST(2, 3) = avg2(K, J);
        DST(0, 3) = avg2(L, K);
        DST(3, 0) = avg3(A, B, C);
        DST(2, 0) = avg3(X, A, B);
        DST(1, 0) = DST(3, 1) = avg3(I, X, A);
        DST(1, 1) = DST(3, 2) = avg3(J, I, X);
        DST(1, 2) = DST(3, 3) = avg3(K, J, I);
        DST(1, 3) = avg3(L, K, J);
        break;
      case B_HU_PRED:
        DST(0, 0) = avg2(I, J);
        DST(2, 0) = DST(0, 1) = avg2(J, K);
        DST(2, 1) = DST(0, 2) = avg2(K, L);
        DST(1, 0) = avg3(I, J, K);
        DST(3, 0) = DST(1, 1) = avg3(J, K, L);
        DST(3, 1) = DST(1, 2) = avg3(K, L, L);
        DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
            static_cast<uint8_t>(L);
        break;
      default:
        fail(kInvalid, "VP8 4x4 mode %d is invalid", mode);
    }
#undef DST
  }

  // 16x16 luma (size 16) or 8x8 chroma (size 8) prediction
  static void predict_block(uint8_t* dst, int size, int mode) {
    int shift = size == 16 ? 5 : 4;
    switch (mode) {
      case DC_PRED: {
        int dc = size;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, size, dc >> shift);
        break;
      }
      case DC_NOTOP: {
        int dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      case DC_NOLEFT: {
        int dc = size >> 1;
        for (int j = 0; j < size; ++j) dc += dst[j - BPS];
        fill(dst, size, dc >> (shift - 1));
        break;
      }
      case DC_NOTOPLEFT:
        fill(dst, size, 0x80);
        break;
      case TM_PRED:
        true_motion(dst, size);
        break;
      case V_PRED:
        for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
        break;
      case H_PRED:
        for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
        break;
      default:
        fail(kInvalid, "VP8 prediction mode %d is invalid", mode);
    }
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : DC_PRED;
    }
    return mode;
  }

  static inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
  static inline int mul2(int a) { return (a * 35468) >> 16; }

  static void idct_add(const int16_t* in, uint8_t* dst) {
    int c[16], *tmp = c;
    for (int i = 0; i < 4; ++i) {
      int a = in[0] + in[8], b = in[0] - in[8];
      int cc = mul2(in[4]) - mul1(in[12]);
      int d = mul1(in[4]) + mul2(in[12]);
      tmp[0] = a + d;
      tmp[1] = b + cc;
      tmp[2] = b - cc;
      tmp[3] = a - d;
      tmp += 4;
      ++in;
    }
    tmp = c;
    for (int i = 0; i < 4; ++i) {
      int dc = tmp[0] + 4;
      int a = dc + tmp[8], b = dc - tmp[8];
      int cc = mul2(tmp[4]) - mul1(tmp[12]);
      int d = mul1(tmp[4]) + mul2(tmp[12]);
      dst[0] = clip8(dst[0] + ((a + d) >> 3));
      dst[1] = clip8(dst[1] + ((b + cc) >> 3));
      dst[2] = clip8(dst[2] + ((b - cc) >> 3));
      dst[3] = clip8(dst[3] + ((a - d) >> 3));
      ++tmp;
      dst += BPS;
    }
  }

  // predict and add the residuals of macroblock (mb_x, mb_y) into the
  // unfiltered planes, on a work buffer bordered as libwebp's
  void reconstruct(const MacroBlock& mb, int mb_x, int mb_y) {
    uint8_t work[BPS * 17 + BPS * 9 * 2 + 64];
    std::memset(work, 0, sizeof(work));
    uint8_t* yd = work + BPS + 8;           // luma: 1 row above, 8 columns left
    uint8_t* ud = work + BPS * 18 + 8;      // chroma: 1 row above each
    uint8_t* vd = ud + BPS * 9;
    const uint8_t* ysrc = y.data();
    // left column and top-left
    for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = mb_x ? ysrc[(mb_y * 16 + j) * ys + mb_x * 16 - 1] : 129;
    for (int j = 0; j < 8; ++j) {
      ud[j * BPS - 1] = mb_x ? u[(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
      vd[j * BPS - 1] = mb_x ? v[(mb_y * 8 + j) * uvs + mb_x * 8 - 1] : 129;
    }
    if (mb_y == 0) {
      std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ud - BPS - 1, 127, 8 + 1);
      std::memset(vd - BPS - 1, 127, 8 + 1);
    } else {
      const uint8_t* above = ysrc + (mb_y * 16 - 1) * ys + mb_x * 16;
      std::memcpy(yd - BPS, above, 16);
      std::memcpy(ud - BPS, &u[(mb_y * 8 - 1) * uvs + mb_x * 8], 8);
      std::memcpy(vd - BPS, &v[(mb_y * 8 - 1) * uvs + mb_x * 8], 8);
      yd[-1 - BPS] = mb_x ? above[-1] : 129;
      ud[-1 - BPS] = mb_x ? u[(mb_y * 8 - 1) * uvs + mb_x * 8 - 1] : 129;
      vd[-1 - BPS] = mb_x ? v[(mb_y * 8 - 1) * uvs + mb_x * 8 - 1] : 129;
      if (mb_x >= mb_w - 1)
        std::memset(yd - BPS + 16, above[15], 4);
      else
        std::memcpy(yd - BPS + 16, above + 16, 4);
    }
    if (mb.is_i4x4) {
      uint8_t* top_right = yd - BPS + 16;
      for (int k = 1; k <= 3; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = yd + (n & 3) * 4 + (n >> 2) * 4 * BPS;
        predict4(dst, mb.imodes[n]);
        idct_add(mb.coeffs + 16 * n, dst);
      }
    } else {
      predict_block(yd, 16, check_mode(mb_x, mb_y, mb.imodes[0]));
      if (mb.nonzero)
        for (int n = 0; n < 16; ++n)
          idct_add(mb.coeffs + 16 * n, yd + (n & 3) * 4 + (n >> 2) * 4 * BPS);
    }
    int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
    predict_block(ud, 8, uvmode);
    predict_block(vd, 8, uvmode);
    for (int n = 0; n < 4; ++n) {
      idct_add(mb.coeffs + 256 + 16 * n, ud + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      idct_add(mb.coeffs + 320 + 16 * n, vd + (n & 1) * 4 + (n >> 1) * 4 * BPS);
    }
    for (int j = 0; j < 16; ++j) std::memcpy(&y[(mb_y * 16 + j) * ys + mb_x * 16], yd + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(&u[(mb_y * 8 + j) * uvs + mb_x * 8], ud + j * BPS, 8);
      std::memcpy(&v[(mb_y * 8 + j) * uvs + mb_x * 8], vd + j * BPS, 8);
    }
  }

  // ------------------------------------------------ loop filters
  static void filter2(uint8_t* p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static void filter4(uint8_t* p, int step) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    int a = 3 * (q0 - p0);
    int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
  static void filter6(uint8_t* p, int step) {
    int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  }
  static bool hev(const uint8_t* p, int step, int thresh) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
  }
  static bool needs(const uint8_t* p, int step, int t) {
    int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
  }
  static bool needs2(const uint8_t* p, int step, int t, int it) {
    int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
  }
  // the simple filter across one edge of 16 pixels: hstride crosses it
  static void simple16(uint8_t* p, int hstride, int vstride, int thresh) {
    int t = 2 * thresh + 1;
    for (int i = 0; i < 16; ++i)
      if (needs(p + i * vstride, hstride, t)) filter2(p + i * vstride, hstride);
  }
  static void loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                   int hev_t, bool edge) {
    int t = 2 * thresh + 1;
    while (size-- > 0) {
      if (needs2(p, hstride, t, ithresh)) {
        if (hev(p, hstride, hev_t))
          filter2(p, hstride);
        else if (edge)
          filter6(p, hstride);
        else
          filter4(p, hstride);
      }
      p += vstride;
    }
  }

  void filter_mb(int mb_x, int mb_y, const FilterInfo& f) {
    int limit = f.limit;
    if (limit == 0) return;
    uint8_t* yd = &y[mb_y * 16 * ys + mb_x * 16];
    if (filter_type == 1) {
      if (mb_x > 0) simple16(yd, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple16(yd + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple16(yd, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple16(yd + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* ud = &u[mb_y * 8 * uvs + mb_x * 8];
    uint8_t* vd = &v[mb_y * 8 * uvs + mb_x * 8];
    int il = f.ilevel, hv = f.hev;
    if (mb_x > 0) {
      loop(yd, 1, ys, 16, limit + 4, il, hv, true);
      loop(ud, 1, uvs, 8, limit + 4, il, hv, true);
      loop(vd, 1, uvs, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) loop(yd + 4 * k, 1, ys, 16, limit, il, hv, false);
      loop(ud + 4, 1, uvs, 8, limit, il, hv, false);
      loop(vd + 4, 1, uvs, 8, limit, il, hv, false);
    }
    if (mb_y > 0) {
      loop(yd, ys, 1, 16, limit + 4, il, hv, true);
      loop(ud, uvs, 1, 8, limit + 4, il, hv, true);
      loop(vd, uvs, 1, 8, limit + 4, il, hv, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) loop(yd + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
      loop(ud + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
      loop(vd + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
    }
  }

  // ------------------------------------------------ the frame
  void decode() {
    parse_header();
    filter_strengths();
    ys = mb_w * 16;
    uvs = mb_w * 8;
    y.assign(static_cast<size_t>(ys) * mb_h * 16, 0);
    u.assign(static_cast<size_t>(uvs) * mb_h * 8, 0);
    v.assign(static_cast<size_t>(uvs) * mb_h * 8, 0);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
    std::vector<uint8_t> tnz(9 * mb_w, 0);
    std::vector<FilterInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    std::vector<MacroBlock> row(mb_w);
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      uint8_t intra_l[4];
      std::memset(intra_l, B_DC_PRED, 4);
      uint8_t lnz[9] = {0};
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_modes(row[mb_x], &intra_t[4 * mb_x], intra_l);
      BoolDecoder& tb = parts[mb_y & (parts.size() - 1)];
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MacroBlock& mb = row[mb_x];
        uint8_t* t = &tnz[9 * mb_x];
        if (!use_skip || !mb.skip) {
          residuals(tb, mb, t, lnz);
        } else {
          std::memset(t, 0, 8);
          std::memset(lnz, 0, 8);
          if (!mb.is_i4x4) t[8] = lnz[8] = 0;
          std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
          mb.nonzero = false;
        }
        if (filter_type > 0) {
          FilterInfo f = fstrengths[mb.segment][mb.is_i4x4];
          f.inner |= mb.nonzero;
          finfo[mb_y * mb_w + mb_x] = f;
        }
        if (tb.past > 8) fail(kInvalid, "VP8 token data ends early (macroblock row %d)", mb_y);
        reconstruct(mb, mb_x, mb_y);
      }
    }
    if (br.past > 8) fail(kInvalid, "VP8 first partition ends early");
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) filter_mb(mb_x, mb_y, finfo[mb_y * mb_w + mb_x]);
  }

  // ------------------------------------------------ YUV -> RGB
  static inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
  static inline uint8_t yuv_clip(int v) {
    return (v & ~16383) == 0 ? static_cast<uint8_t>(v >> 6) : v < 0 ? 0 : 255;
  }
  static inline void to_rgb(int yy, int uu, int vv, uint8_t* rgb) {
    rgb[0] = yuv_clip(mult_hi(yy, 19077) + mult_hi(vv, 26149) - 14234);
    rgb[1] = yuv_clip(mult_hi(yy, 19077) - mult_hi(uu, 6419) - mult_hi(vv, 13320) + 8708);
    rgb[2] = yuv_clip(mult_hi(yy, 19077) + mult_hi(uu, 33050) - 17685);
  }

  // libwebp's fancy upsampler for one pair of output rows: chroma rows
  // `top` (nearer the upper row) and `cur` (nearer the lower)
  void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                     const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                     uint8_t* top_dst, uint8_t* bottom_dst, int len) const {
    int last_pair = (len - 1) >> 1;
    int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
    to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bottom_y)
      to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
    for (int x = 1; x <= last_pair; ++x) {
      int t_u = top_u[x], t_v = top_v[x], c_u = cur_u[x], c_v = cur_v[x];
      int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
      int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
      int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
      to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + 3 * (2 * x - 1));
      to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 3 * (2 * x));
      if (bottom_y) {
        to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
               bottom_dst + 3 * (2 * x - 1));
        to_rgb(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, bottom_dst + 3 * (2 * x));
      }
      tl_u = t_u;
      tl_v = t_v;
      l_u = c_u;
      l_v = c_v;
    }
    if (!(len & 1)) {
      to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
             top_dst + 3 * (len - 1));
      if (bottom_y)
        to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
               bottom_dst + 3 * (len - 1));
    }
  }

  std::vector<uint8_t> rgb() const {
    std::vector<uint8_t> out(static_cast<size_t>(width) * height * 3);
    auto row = [&](int r) { return out.data() + static_cast<size_t>(r) * width * 3; };
    auto yrow = [&](int r) { return y.data() + static_cast<size_t>(r) * ys; };
    auto urow = [&](int r) { return u.data() + static_cast<size_t>(r) * uvs; };
    auto vrow = [&](int r) { return v.data() + static_cast<size_t>(r) * uvs; };
    upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), row(0), nullptr, width);
    int yy = 0;
    for (; yy + 2 < height; yy += 2) {
      int k = yy / 2;
      upsample_pair(yrow(yy + 1), yrow(yy + 2), urow(k), vrow(k), urow(k + 1), vrow(k + 1),
                    row(yy + 1), row(yy + 2), width);
    }
    if (!(height & 1)) {
      int k = (height - 1) / 2;
      upsample_pair(yrow(height - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                    row(height - 1), nullptr, width);
    }
    return out;
  }
};

// --------------------------------------------------------- VP8L (lossless)
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // in bits
  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}
  uint32_t read(int n) {
    if (pos + n > size * 8) fail(kInvalid, "VP8L data ends early (byte %zu)", size);
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos)
      v |= static_cast<uint32_t>((data[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  int bit() {
    if (pos >= size * 8) fail(kInvalid, "VP8L data ends early (byte %zu)", size);
    int b = (data[pos >> 3] >> (pos & 7)) & 1;
    ++pos;
    return b;
  }
};

// a canonical prefix code, read a bit at a time (first bit = the code's most
// significant); a code of one used symbol takes no bits
struct Prefix {
  int single = -1;
  int first[16] = {0}, count[16] = {0}, offset[16] = {0};
  std::vector<int> sorted;

  void build(const std::vector<int>& lengths) {
    int used = 0, last = -1;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++used;
        last = static_cast<int>(s);
        ++count[lengths[s]];
      }
    if (used == 0) fail(kInvalid, "VP8L prefix code has no symbols");
    if (used == 1) {
      single = last;
      return;
    }
    // the code must be complete
    long long room = 1;
    for (int len = 1; len < 16; ++len) {
      room = 2 * room - count[len];
      if (room < 0) fail(kInvalid, "VP8L prefix code is over-subscribed");
    }
    if (room != 0) fail(kInvalid, "VP8L prefix code is incomplete");
    int code = 0, at = 0;
    for (int len = 1; len < 16; ++len) {
      first[len] = code;
      offset[len] = at;
      at += count[len];
      code = (code + count[len]) << 1;
    }
    sorted.assign(used, 0);
    int fill[16];
    std::memcpy(fill, offset, sizeof(fill));
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) sorted[fill[lengths[s]]++] = static_cast<int>(s);
  }
  int read(BitReader& br) const {
    if (single >= 0) return single;
    int code = 0;
    for (int len = 1; len < 16; ++len) {
      code = (code << 1) | br.bit();
      if (code - first[len] < count[len]) return sorted[offset[len] + code - first[len]];
    }
    fail(kInvalid, "VP8L prefix code is invalid at bit %zu", br.pos);
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

Prefix read_code(BitReader& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    int n = br.read(1) + 1;
    int s0 = br.read(br.read(1) ? 8 : 1);
    if (s0 >= alphabet) fail(kInvalid, "VP8L simple code symbol %d is out of range", s0);
    lengths[s0] = 1;
    if (n == 2) {
      int s1 = br.read(8);
      if (s1 >= alphabet) fail(kInvalid, "VP8L simple code symbol %d is out of range", s1);
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    int n = 4 + br.read(4);
    for (int i = 0; i < n; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Prefix lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) fail(kInvalid, "VP8L code length count %d is too large", max_symbol);
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      int len = lc.read(br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        int slot = len - 16;
        int repeat = br.read(extra[slot]) + base[slot];
        if (symbol + repeat > alphabet) fail(kInvalid, "VP8L code lengths run past the alphabet");
        int value = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = value;
      }
    }
  }
  Prefix p;
  p.build(lengths);
  return p;
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Group {
  Prefix codes[5];  // green+length+cache, red, blue, alpha, distance
};

inline int copy_value(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

// an entropy-coded image of xsize * ysize ARGB pixels (the main image when
// `main`, which may use meta prefix codes)
std::vector<uint32_t> read_image(BitReader& br, int xsize, int ysize, bool main) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) fail(kInvalid, "VP8L colour cache of %d bits", cache_bits);
  }
  int meta_bits = 0;
  std::vector<uint32_t> meta;
  int groups = 1;
  if (main && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta = read_image(br, subsample(xsize, meta_bits), subsample(ysize, meta_bits), false);
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if (static_cast<int>(m) + 1 > groups) groups = m + 1;
    }
  }
  int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<Group> g(groups);
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  for (Group& group : g)
    for (int i = 0; i < 5; ++i) group.codes[i] = read_code(br, alphabets[i]);
  std::vector<uint32_t> cache(cache_size, 0);
  std::vector<uint32_t> px(static_cast<size_t>(xsize) * ysize);
  size_t total = px.size(), at = 0, cached = 0;
  int meta_w = meta_bits ? subsample(xsize, meta_bits) : 0;
  auto insert = [&](size_t upto) {
    for (; cached < upto; ++cached)
      cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
  };
  while (at < total) {
    int col = static_cast<int>(at % xsize), row = static_cast<int>(at / xsize);
    const Group& group =
        meta_bits ? g[meta[(row >> meta_bits) * meta_w + (col >> meta_bits)]] : g[0];
    int code = group.codes[0].read(br);
    if (code < 256) {
      uint32_t red = group.codes[1].read(br), blue = group.codes[2].read(br),
               alpha = group.codes[3].read(br);
      px[at++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
    } else if (code < 256 + 24) {
      int length = copy_value(code - 256, br);
      int dist_code = copy_value(group.codes[4].read(br), br);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        int plane = kCodeToPlane[dist_code - 1];
        dist = (plane >> 4) * xsize + 8 - (plane & 0xf);
        if (dist < 1) dist = 1;
      }
      if (static_cast<size_t>(dist) > at || total - at < static_cast<size_t>(length))
        fail(kInvalid, "VP8L backward reference (distance %d, length %d) leaves the image", dist,
             length);
      for (int i = 0; i < length; ++i, ++at) px[at] = px[at - dist];
    } else {
      if (!cache_bits) fail(kInvalid, "VP8L colour cache code without a cache");
      insert(at);
      px[at++] = cache[code - 256 - 24];
    }
    if (cache_bits) insert(at);
  }
  return px;
}

inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 255) +
                                         static_cast<int>((b >> s) & 255) -
                                         static_cast<int>((c >> s) & 255)))
           << s;
  return out;
}
inline uint32_t add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    int x = static_cast<int>((a >> s) & 255), y = static_cast<int>((b >> s) & 255);
    out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  int diff = 0;
  for (int s = 0; s < 32; s += 8) {
    int ta = static_cast<int>((a >> s) & 255), tb = static_cast<int>((b >> s) & 255),
        tc = static_cast<int>((c >> s) & 255);
    diff += std::abs(tb - tc) - std::abs(ta - tc);
  }
  return diff <= 0 ? a : b;
}
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  uint32_t T = top[0], TR = top[1], TL = top[-1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return add_subtract_full(L, T, TL);
    case 13: return add_subtract_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and 14 and 15 as libwebp reads them
  }
}

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

std::vector<uint8_t> decode_vp8l(const uint8_t* data, size_t size, int* out_w, int* out_h) {
  if (size < 5 || data[0] != 0x2f) fail(kInvalid, "VP8L stream lacks its signature byte");
  BitReader br(data + 1, size - 1);
  int width = br.read(14) + 1, height = br.read(14) + 1;
  br.read(1);  // alpha is used
  if (br.read(3) != 0) fail(kInvalid, "VP8L version is not 0");
  std::vector<Transform> transforms;
  int xsize = width;
  unsigned seen = 0;
  while (br.read(1)) {
    int type = br.read(2);
    if (seen & (1u << type)) fail(kInvalid, "VP8L transform %d appears twice", type);
    seen |= 1u << type;
    Transform t{type, 0, xsize, {}};
    if (type == 0 || type == 1) {
      t.bits = br.read(3) + 2;
      t.data = read_image(br, subsample(xsize, t.bits), subsample(height, t.bits), false);
    } else if (type == 3) {
      int colors = br.read(8) + 1;
      t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
      std::vector<uint32_t> pal = read_image(br, colors, 1, false);
      t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < colors; ++i) t.data[i] = add_pixels(pal[i], t.data[i - 1]);
      xsize = subsample(xsize, t.bits);
    }
    transforms.push_back(std::move(t));
  }
  std::vector<uint32_t> px = read_image(br, xsize, height, true);
  for (auto it = transforms.rbegin(); it != transforms.rend(); ++it) {
    const Transform& t = *it;
    int w = t.xsize;
    if (t.type == 0) {
      int bw = subsample(w, t.bits);
      // row 0: black then left; column 0: top; the rest by the block's mode
      px[0] = add_pixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = add_pixels(px[x], px[x - 1]);
      for (int yy = 1; yy < height; ++yy) {
        uint32_t* row = &px[static_cast<size_t>(yy) * w];
        const uint32_t* top = row - w;
        row[0] = add_pixels(row[0], top[0]);
        for (int x = 1; x < w; ++x) {
          int mode = (t.data[(yy >> t.bits) * bw + (x >> t.bits)] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row[x - 1], top + x));
        }
      }
    } else if (t.type == 1) {
      int bw = subsample(w, t.bits);
      for (int yy = 0; yy < height; ++yy)
        for (int x = 0; x < w; ++x) {
          uint32_t code = t.data[(yy >> t.bits) * bw + (x >> t.bits)];
          int8_t g2r = static_cast<int8_t>(code & 255), g2b = static_cast<int8_t>((code >> 8) & 255),
                 r2b = static_cast<int8_t>((code >> 16) & 255);
          uint32_t& argb = px[static_cast<size_t>(yy) * w + x];
          int8_t green = static_cast<int8_t>(argb >> 8);
          int red = (argb >> 16) & 255, blue = argb & 255;
          red = (red + ((g2r * green) >> 5)) & 255;
          blue += (g2b * green) >> 5;
          blue += (r2b * static_cast<int8_t>(red)) >> 5;
          blue &= 255;
          argb = (argb & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
    } else if (t.type == 2) {
      for (uint32_t& argb : px) {
        uint32_t green = (argb >> 8) & 255;
        uint32_t rb = ((argb & 0x00ff00ffu) + ((green << 16) | green)) & 0x00ff00ffu;
        argb = (argb & 0xff00ff00u) | rb;
      }
    } else {
      int packed_w = subsample(w, t.bits);
      std::vector<uint32_t> out(static_cast<size_t>(w) * height);
      int per = 1 << t.bits, bits_per = 8 >> t.bits, mask = (1 << bits_per) - 1;
      for (int yy = 0; yy < height; ++yy)
        for (int x = 0; x < w; ++x) {
          uint32_t packed = (px[static_cast<size_t>(yy) * packed_w + x / per] >> 8) & 255;
          uint32_t index = (packed >> ((x % per) * bits_per)) & mask;
          out[static_cast<size_t>(yy) * w + x] = t.data[index];
        }
      px.swap(out);
    }
  }
  std::vector<uint8_t> rgb(static_cast<size_t>(width) * height * 3);
  for (size_t i = 0; i < px.size(); ++i) {
    rgb[3 * i] = static_cast<uint8_t>(px[i] >> 16);
    rgb[3 * i + 1] = static_cast<uint8_t>(px[i] >> 8);
    rgb[3 * i + 2] = static_cast<uint8_t>(px[i]);
  }
  *out_w = width;
  *out_h = height;
  return rgb;
}

// A VP8 (kind 0) or VP8L (kind 1) chunk payload data[0, size) as RGB rows
std::vector<uint8_t> decode_frame(const uint8_t* data, size_t size, int kind, int* height,
                                  int* width) {
  if (kind == 1) return decode_vp8l(data, size, width, height);
  Vp8 d(data, size);
  d.decode();
  *width = d.width;
  *height = d.height;
  return d.rgb();
}

uint32_t le32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | p[1] << 8 | p[2] << 16 | static_cast<uint32_t>(p[3]) << 24;
}

// A FourCC as Python writes a bytes object (b'VP8 '), for the messages
std::string fourcc_repr(const uint8_t* p) {
  const bool dq = std::memchr(p, '\'', 4) != nullptr && std::memchr(p, '"', 4) == nullptr;
  const char quote = dq ? '"' : '\'';
  std::string out = "b";
  out += quote;
  for (int i = 0; i < 4; ++i) {
    const uint8_t c = p[i];
    char buf[8];
    if (c == quote || c == '\\') {
      out += '\\';
      out += static_cast<char>(c);
    } else if (c == '\t') {
      out += "\\t";
    } else if (c == '\n') {
      out += "\\n";
    } else if (c == '\r') {
      out += "\\r";
    } else if (c < 0x20 || c >= 0x7f) {
      std::snprintf(buf, sizeof buf, "\\x%02x", c);
      out += buf;
    } else {
      out += static_cast<char>(c);
    }
  }
  out += quote;
  return out;
}

// The WebP file data[0, n) as RGB rows: its RIFF chunks walked, a simple or
// extended file's frame decoded, the EXIF orientation applied when asked for
std::vector<uint8_t> decode_file(const uint8_t* d, size_t n, bool exif_orientation, int* height,
                                 int* width) {
  if (n < 20 || std::memcmp(d, "RIFF", 4) != 0 || std::memcmp(d + 8, "WEBP", 4) != 0)
    fail(kInvalid, "not a WebP file (no RIFF/WEBP header)");
  const uint32_t riff = le32(d + 4);
  const uint64_t end = static_cast<uint64_t>(riff) + 8;
  if (end > n)
    fail(kInvalid, "WebP RIFF size %u runs past the end of the file (%zu bytes)", riff, n);
  struct Chunk {
    const uint8_t* kind;
    size_t at, size;
  };
  std::vector<Chunk> chunks;
  for (uint64_t at = 12; at + 8 <= end;) {
    const uint32_t size = le32(d + at + 4);
    if (at + 8 + size > end)
      fail(kInvalid, "WebP chunk %s at byte %llu runs past the end of the file",
           fourcc_repr(d + at).c_str(), static_cast<unsigned long long>(at));
    chunks.push_back({d + at, static_cast<size_t>(at + 8), size});
    at += 8 + static_cast<uint64_t>(size) + (size & 1);
  }
  if (chunks.empty()) fail(kInvalid, "WebP file holds no chunk");
  auto is = [](const Chunk& c, const char* name) { return std::memcmp(c.kind, name, 4) == 0; };
  int canvas_h = -1, canvas_w = -1;
  const Chunk* exif = nullptr;
  if (is(chunks[0], "VP8X")) {
    const Chunk& x = chunks[0];
    if (x.size < 10) fail(kInvalid, "WebP VP8X chunk at byte %zu is truncated", x.at - 8);
    bool animated = (d[x.at] & 0x02) != 0;
    for (const Chunk& c : chunks) animated = animated || is(c, "ANIM") || is(c, "ANMF");
    if (animated) fail(kUnsupported, "animated WebP is not supported by this decoder");
    canvas_w = static_cast<int>(d[x.at + 4] | d[x.at + 5] << 8 | d[x.at + 6] << 16) + 1;
    canvas_h = static_cast<int>(d[x.at + 7] | d[x.at + 8] << 8 | d[x.at + 9] << 16) + 1;
    for (const Chunk& c : chunks) {
      if (is(c, "EXIF")) {
        exif = &c;
        break;
      }
    }
  }
  const Chunk* frame = nullptr;
  for (const Chunk& c : chunks) {
    if (is(c, "VP8 ") || is(c, "VP8L")) {
      frame = &c;
      break;
    }
  }
  if (frame == nullptr) fail(kInvalid, "WebP file holds no VP8 or VP8L chunk");
  const int kind = is(*frame, "VP8L") ? 1 : 0;
  std::vector<uint8_t> rgb;
  try {
    rgb = decode_frame(d + frame->at, frame->size, kind, height, width);
  } catch (const Failure& f) {
    fail(f.status, "WebP %s data at byte %zu: %s", kind ? "VP8L" : "VP8", frame->at,
         f.message.c_str());
  }
  if (canvas_h >= 0 && (canvas_h != *height || canvas_w != *width))
    fail(kInvalid, "WebP canvas %dx%d differs from its image %dx%d", canvas_w, canvas_h,
         *width, *height);
  if (exif_orientation && exif != nullptr)
    vitssl::apply_orientation(rgb, *height, *width,
                              vitssl::exif_orientation(d + exif->at, exif->size));
  return rgb;
}

}  // namespace

extern "C" {

// Decode the WebP file data[0, size) to RGB uint8 (height, width, 3) rows,
// the EXIF orientation applied when exif_orientation is nonzero. Returns 0
// and sets *out (release it with webp_free), *height and *width; 1 for an
// animation, 2 for damaged data, with a message in msg.
int webp_decode(const uint8_t* data, size_t size, int exif_orientation, uint8_t** out,
                int* height, int* width, char* msg, int msg_size) {
  *out = nullptr;
  try {
    const std::vector<uint8_t> rgb = decode_file(data, size, exif_orientation != 0, height,
                                                 width);
    *out = static_cast<uint8_t*>(std::malloc(rgb.size()));
    if (*out == nullptr) throw std::bad_alloc();
    std::memcpy(*out, rgb.data(), rgb.size());
    return kOk;
  } catch (const Failure& f) {
    std::snprintf(msg, msg_size, "%s", f.message.c_str());
    return f.status;
  } catch (const std::bad_alloc&) {
    std::snprintf(msg, msg_size, "out of memory");
    return kInvalid;
  }
}

void webp_free(uint8_t* p) { std::free(p); }

}  // extern "C"
