// The bit-level parts of the host's WebP reader (feartracker_tpu_torch/
// data/webp.py builds and binds it with ctypes; the RIFF container is parsed
// in Python). Each decoder gives the pixels that libwebp gives OpenCV 5.0's
// cv2.imread (WebPDecodeBGRInto's defaults: fancy upsampling, no dithering):
//
// webp_vp8: a lossy key frame (RFC 6386): the boolean decoder, the segment,
// filter, partition and quantizer headers, the coefficient probability
// updates, intra modes, tokens, the inverse WHT and DCT, prediction on
// libwebp's borders (127 above the frame, 129 left of it), the simple and
// normal loop filters in macroblock raster order after the frame is built,
// then libwebp's "fancy" 2x chroma upsampler and its fixed-point YUV->RGB
// (src/dsp/yuv.h), all in integers.
//
// webp_vp8l: a lossless image: prefix codes (simple and normal), the colour
// cache, LZ77 backward references with the distance map, meta prefix codes,
// and the predictor, cross-colour, subtract-green and colour-indexing (with
// pixel bundling) transforms, undone in reverse order. Out: RGB, the alpha
// dropped as the BGR decode drops it.
//
// Every function returns 0 on success, else writes a message to err.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};
[[noreturn]] void fail(const std::string& m) { throw Error{m}; }

// RFC 6386's default coefficient probabilities (13.5), their update
// probabilities (13.4) and key-frame subblock mode probabilities (11.5, in
// the mode order below), and the quantizer tables (14.1)
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
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
// the WebP lossless format's distance map: (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------------ VP8

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// intra modes in libwebp's order; the 16x16 and chroma modes share the first four
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU, DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };

inline int floor_log2(uint32_t v) {
  int n = 0;
  while (v >>= 1) n++;
  return n;
}

// libwebp's boolean decoder: range_ holds range - 1, value_ the unread bits
struct BoolDec {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 255 - 1;
  bool eof = false;

  void init(const uint8_t* data, size_t n) {
    p = data;
    end = data + n;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    while (bits < 0) {
      if (p < end) {
        value = (value << 8) | *p++;
        bits += 8;
      } else if (!eof) {
        value <<= 8;
        bits += 8;
        eof = true;
      } else {
        bits = 0;
        break;
      }
    }
  }
  int bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    const int b = v > split;
    if (b) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
    } else {
      r = split + 1;
    }
    const int shift = 7 ^ floor_log2(r);
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  int get_signed(int v) {
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;  // -1 or 0
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get(  ) ? -v : v;
  }
  int get() { return (int)get_value(1); }
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};
struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};
struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

constexpr int BPS = 32;  // libwebp's work buffer: Y at row 1, col 8; U and V below it side by side
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS, 8 + 0 * BPS,  12 + 0 * BPS, 0 + 4 * BPS,  4 + 4 * BPS,
                       8 + 4 * BPS,  12 + 4 * BPS, 0 + 8 * BPS, 4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                       0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// -- intra predictors on the work buffer (dst at the block's top-left)

inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, (size_t)size);
}

void predict_block(uint8_t* dst, int mode, int size) {  // 16x16 luma or 8x8 chroma
  const int shift = size == 16 ? 5 : 4;
  switch (mode) {
    case B_DC: {
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
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, (size_t)size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], (size_t)size);
      break;
    default:
      fail("VP8: bad 16x16 or chroma intra mode");
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, (int)dc, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]), avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]), avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS], D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
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
    }
    case B_VL: {
      const int A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS], D = dst[3 - BPS];
      const int E = dst[4 - BPS], F = dst[5 - BPS], G = dst[6 - BPS], H = dst[7 - BPS];
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
    }
    case B_HU: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
    }
    case B_HD: {
      const int I = dst[-1 + 0 * BPS], J = dst[-1 + 1 * BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
      const int X = dst[-1 - BPS], A = dst[0 - BPS], B = dst[1 - BPS], C = dst[2 - BPS];
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
    }
    default:
      fail("VP8: bad 4x4 intra mode");
  }
}

#undef DST

// -- loop filters (libwebp's dsp/dec.c, on a plane with the given stride)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020] -> [-128, 127]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112] -> [-16, 15]
inline int abs0(int v) { return v < 0 ? -v : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs0(p1 - p0) > thresh || abs0(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs0(p0 - q0) + abs0(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs0(p0 - q0) + abs0(p1 - q1) > t) return false;
  return abs0(p3 - p2) <= it && abs0(p2 - p1) <= it && abs0(p1 - p0) <= it && abs0(q3 - q2) <= it &&
         abs0(q2 - q1) <= it && abs0(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int step, int along, int thresh) {  // 16 pixels across one edge
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (needs_filter(p + i * along, step, thresh2)) do_filter2(p + i * along, step);
}

void filter_loop26(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter6(p, hstride);
    }
    p += vstride;
  }
}

void filter_loop24(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_thresh) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, thresh2, ithresh)) {
      if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
      else do_filter4(p, hstride);
    }
    p += vstride;
  }
}

struct VP8 {
  int W = 0, H = 0, mbw = 0, mbh = 0;
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  bool simple = false, use_lf_delta = false;
  int level = 0, sharpness = 0, ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip = false;
  int skip_p = 0;
  BoolDec br;
  std::vector<BoolDec> parts;
  FInfo fstrengths[4][2];
  std::vector<uint8_t> Y, U, V;
  int ys = 0, uvs = 0;

  void parse(const uint8_t* buf, size_t size) {
    if (size < 10) fail("VP8: truncated frame header");
    const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const int show = (bits >> 4) & 1;
    const uint32_t partition_length = bits >> 5;
    if (!key_frame) fail("VP8: not a key frame");
    if (profile > 3) fail("VP8: incorrect keyframe parameters");
    if (!show) fail("VP8: frame not displayable");
    if (buf[3] != 0x9d || buf[4] != 0x01 || buf[5] != 0x2a) fail("VP8: bad code word");
    W = ((buf[7] << 8) | buf[6]) & 0x3fff;
    H = ((buf[9] << 8) | buf[8]) & 0x3fff;
    if (W == 0 || H == 0) fail("VP8: frame of zero size");
    mbw = (W + 15) >> 4;
    mbh = (H + 15) >> 4;
    buf += 10;
    size -= 10;
    if (partition_length > size) fail("VP8: bad partition length");
    br.init(buf, partition_length);
    buf += partition_length;
    size -= partition_length;
    br.get();  // colour space
    br.get();  // clamping type
    // segment header
    use_segment = br.get();
    if (use_segment) {
      update_map = br.get();
      if (br.get()) {
        absolute_delta = br.get();
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get() ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get() ? br.get_signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_proba[s] = br.get() ? (uint8_t)br.get_value(8) : 255;
    }
    // filter header
    simple = br.get();
    level = (int)br.get_value(6);
    sharpness = (int)br.get_value(3);
    use_lf_delta = br.get();
    if (use_lf_delta && br.get()) {
      for (int i = 0; i < 4; ++i)
        if (br.get()) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get()) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // partitions
    const int last_part = (1 << br.get_value(2)) - 1;
    if (size < 3 * (size_t)last_part) fail("VP8: cannot parse partitions");
    const uint8_t* sz = buf;
    const uint8_t* part_start = buf + last_part * 3;
    size_t size_left = size - last_part * 3;
    parts.resize(last_part + 1);
    for (int p = 0; p < last_part; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part_start, psize);
      part_start += psize;
      size_left -= psize;
      sz += 3;
    }
    parts[last_part].init(part_start, size_left);
    if (part_start >= buf + size) fail("VP8: cannot parse partitions (data ends early)");
    // quantizers
    const int base_q0 = (int)br.get_value(7);
    const int dqy1_dc = br.get() ? br.get_signed_value(4) : 0;
    const int dqy2_dc = br.get() ? br.get_signed_value(4) : 0;
    const int dqy2_ac = br.get() ? br.get_signed_value(4) : 0;
    const int dquv_dc = br.get() ? br.get_signed_value(4) : 0;
    const int dquv_ac = br.get() ? br.get_signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment) {
        q = quantizer[i];
        if (!absolute_delta) q += base_q0;
      } else {
        if (i > 0) {
          dqm[i] = dqm[0];
          continue;
        }
        q = base_q0;
      }
      QuantMatrix& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q + 0, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
    br.get();  // refresh entropy probabilities: one frame, no effect
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int k = ((t * 8 + b) * 3 + c) * 11 + p;
            proba[t][b][c][p] = br.bit(kCoeffsUpdateProba[k]) ? (uint8_t)br.get_value(8) : kCoeffsProba0[k];
          }
    use_skip = br.get();
    if (use_skip) skip_p = (int)br.get_value(8);
    precompute_filter_strengths();
  }

  void precompute_filter_strengths() {
    if (filter_type == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base_level;
      if (use_segment) {
        base_level = filter_strength[s];
        if (!absolute_delta) base_level += level;
      } else {
        base_level = level;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = (uint8_t)ilevel;
          info.limit = (uint8_t)(2 * lvl + ilevel);
          info.hev = (uint8_t)(lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0);
        } else {
          info.limit = 0;
        }
        info.inner = (uint8_t)i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& b, uint8_t* top, uint8_t* left) {
    b.segment = update_map ? (uint8_t)(!br.bit(seg_proba[0]) ? br.bit(seg_proba[1]) : br.bit(seg_proba[2]) + 2) : 0;
    b.skip = use_skip ? (uint8_t)br.bit(skip_p) : 0;
    b.is_i4x4 = !br.bit(145);
    if (!b.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
      b.imodes[0] = (uint8_t)ymode;
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          ymode = !br.bit(prob[0])   ? B_DC
                  : !br.bit(prob[1]) ? B_TM
                  : !br.bit(prob[2]) ? B_VE
                  : !br.bit(prob[3]) ? (!br.bit(prob[4]) ? B_HE : (!br.bit(prob[5]) ? B_RD : B_VR))
                                     : (!br.bit(prob[6]) ? B_LD
                                                         : (!br.bit(prob[7]) ? B_VL : (!br.bit(prob[8]) ? B_HD : B_HU)));
          top[x] = (uint8_t)ymode;
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    b.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
  }

  int large_value(BoolDec& tb, const uint8_t* p) {
    int v;
    if (!tb.bit(p[3])) {
      if (!tb.bit(p[4])) v = 2;
      else v = 3 + tb.bit(p[5]);
    } else {
      if (!tb.bit(p[6])) {
        if (!tb.bit(p[7])) {
          v = 5 + tb.bit(159);
        } else {
          v = 7 + 2 * tb.bit(165);
          v += tb.bit(145);
        }
      } else {
        const int bit1 = tb.bit(p[8]);
        const int bit0 = tb.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.bit(*tab);
        v += 3 + (8 << cat);
      }
    }
    return v;
  }

  int get_coeffs(BoolDec& tb, int t, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[t][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.bit(p[0])) return n;
      while (!tb.bit(p[1])) {
        p = proba[t][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!tb.bit(p[2])) {
        v = 1;
        p = proba[t][kBands[n + 1]][1];
      } else {
        v = large_value(tb, p);
        p = proba[t][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = (int16_t)(tb.get_signed(v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
    return nz_coeffs;
  }

  // 1 when the macroblock has no non-zero coefficient (libwebp's ParseResiduals)
  int parse_residuals(BoolDec& tb, MBData& block, uint8_t& mb_nz, uint8_t& mb_nz_dc, uint8_t& left_nz,
                      uint8_t& left_nz_dc) {
    const QuantMatrix& q = dqm[block.segment];
    int16_t* dst = block.coeffs;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    memset(dst, 0, 384 * sizeof(*dst));
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb_nz_dc + left_nz_dc;
      const int nz = get_coeffs(tb, 1, ctx, q.y2, 0, dc);
      mb_nz_dc = left_nz_dc = (uint8_t)(nz > 0);
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 16 * 16; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t tnz = mb_nz & 0x0f, lnz = left_nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_type, ctx, q.y1, first, dst);
        l = nz > first;
        tnz = (tnz >> 1) | ((uint32_t)l << 7);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (lnz >> 1) | ((uint32_t)l << 7);
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = (uint32_t)mb_nz >> (4 + ch);
      lnz = (uint32_t)left_nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tb, 2, ctx, q.uv, 0, dst);
          l = nz > 0;
          tnz = (tnz >> 1) | ((uint32_t)l << 3);
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (lnz >> 1) | ((uint32_t)l << 5);
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= (tnz << 4) << ch;
      out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb_nz = (uint8_t)out_t_nz;
    left_nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC) {
      if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
      return mb_y == 0 ? DC_NOTOP : B_DC;
    }
    return mode;
  }

  void decode() {
    ys = mbw * 16;
    uvs = mbw * 8;
    Y.assign((size_t)ys * mbh * 16, 0);
    U.assign((size_t)uvs * mbh * 8, 0);
    V.assign((size_t)uvs * mbh * 8, 0);
    std::vector<uint8_t> intra_t((size_t)4 * mbw, B_DC), mb_nz(mbw, 0), mb_nz_dc(mbw, 0);
    std::vector<uint8_t> top_y((size_t)16 * mbw), top_u((size_t)8 * mbw), top_v((size_t)8 * mbw);
    std::vector<FInfo> finfo((size_t)mbw * mbh);
    std::vector<MBData> row(mbw);
    uint8_t yuv_b[BPS * 17 + BPS * 9];
    memset(yuv_b, 0, sizeof(yuv_b));
    for (int mb_y = 0; mb_y < mbh; ++mb_y) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      for (int mb_x = 0; mb_x < mbw; ++mb_x) parse_intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) fail("VP8: premature end of partition 0");
      BoolDec& tb = parts[mb_y & (parts.size() - 1)];
      uint8_t left_nz = 0, left_nz_dc = 0;
      for (int mb_x = 0; mb_x < mbw; ++mb_x) {
        MBData& block = row[mb_x];
        int skip = use_skip ? block.skip : 0;
        if (!skip) {
          skip = parse_residuals(tb, block, mb_nz[mb_x], mb_nz_dc[mb_x], left_nz, left_nz_dc);
        } else {
          left_nz = mb_nz[mb_x] = 0;
          if (!block.is_i4x4) left_nz_dc = mb_nz_dc[mb_x] = 0;
          block.non_zero_y = block.non_zero_uv = 0;
          memset(block.coeffs, 0, sizeof(block.coeffs));
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[block.segment][block.is_i4x4];
          f.inner |= !skip;
          finfo[(size_t)mb_y * mbw + mb_x] = f;
        }
        if (tb.eof) fail("VP8: premature end of a token partition");
      }
      reconstruct_row(mb_y, row, yuv_b, top_y, top_u, top_v);
    }
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mbh; ++mb_y)
        for (int mb_x = 0; mb_x < mbw; ++mb_x) do_filter(mb_x, mb_y, finfo[(size_t)mb_y * mbw + mb_x]);
  }

  void reconstruct_row(int mb_y, const std::vector<MBData>& row, uint8_t* yuv_b, std::vector<uint8_t>& top_y,
                       std::vector<uint8_t>& top_u, std::vector<uint8_t>& top_v) {
    uint8_t* const y_dst = yuv_b + Y_OFF;
    uint8_t* const u_dst = yuv_b + U_OFF;
    uint8_t* const v_dst = yuv_b + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mbw; ++mb_x) {
      const MBData& block = row[mb_x];
      if (mb_x > 0) {  // the left samples from the previous block
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mbw - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
          else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n) {
          uint8_t* dst = y_dst + kScan[n];
          predict4(dst, block.imodes[n]);
          transform_one(coeffs + n * 16, dst);
        }
      } else {
        predict_block(y_dst, check_mode(mb_x, mb_y, block.imodes[0]), 16);
        if (block.non_zero_y)
          for (int n = 0; n < 16; ++n) transform_one(coeffs + n * 16, y_dst + kScan[n]);
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(u_dst, uvmode, 8);
      predict_block(v_dst, uvmode, 8);
      if (block.non_zero_uv & 0xff)
        for (int n = 0; n < 4; ++n) transform_one(coeffs + 256 + n * 16, u_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      if (block.non_zero_uv & 0xff00)
        for (int n = 0; n < 4; ++n) transform_one(coeffs + 320 + n * 16, v_dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
      if (mb_y < mbh - 1) {
        memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
        memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
        memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j) memcpy(&Y[(size_t)(mb_y * 16 + j) * ys + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&U[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&V[(size_t)(mb_y * 8 + j) * uvs + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }

  void do_filter(int mb_x, int mb_y, const FInfo& f) {
    const int limit = f.limit;
    if (limit == 0) return;
    uint8_t* y_dst = &Y[(size_t)mb_y * 16 * ys + mb_x * 16];
    const int ilevel = f.ilevel;
    if (filter_type == 1) {  // simple: luma only
      if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
      if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
      if (f.inner)
        for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
      return;
    }
    uint8_t* u_dst = &U[(size_t)mb_y * 8 * uvs + mb_x * 8];
    uint8_t* v_dst = &V[(size_t)mb_y * 8 * uvs + mb_x * 8];
    const int hev_t = f.hev;
    if (mb_x > 0) {
      filter_loop26(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t);
    }
    if (mb_y > 0) {
      filter_loop26(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t);
      filter_loop26(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
      filter_loop26(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop24(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t);
      filter_loop24(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
      filter_loop24(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t);
    }
  }
};

// -- libwebp's YUV->RGB (src/dsp/yuv.h) and fancy upsampler (src/dsp/upsampling.c)

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip_yuv(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = (uint8_t)clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = (uint8_t)clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = (uint8_t)clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row from its luma row and two chroma rows: the nearer (near_*)
// weighs 3, the farther 1, in both directions, as UpsampleRgbLinePair does
// for its top (near = top chroma row) or bottom (near = current) output
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v, const uint8_t* far_u,
                  const uint8_t* far_v, uint8_t* dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = near_u[0], tl_v = near_v[0], l_u = far_u[0], l_v = far_v[0];
  yuv_to_rgb(y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = near_u[x], t_v = near_v[x], u = far_u[x], v = far_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int diag12_u = (avg_u + 2 * (t_u + l_u)) >> 3, diag12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int diag03_u = (avg_u + 2 * (tl_u + u)) >> 3, diag03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(y[2 * x - 1], (diag12_u + tl_u) >> 1, (diag12_v + tl_v) >> 1, dst + (2 * x - 1) * 3);
    yuv_to_rgb(y[2 * x], (diag03_u + t_u) >> 1, (diag03_v + t_v) >> 1, dst + 2 * x * 3);
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) yuv_to_rgb(y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, dst + (len - 1) * 3);
}

void emit_fancy_rgb(const VP8& d, uint8_t* out) {
  const int W = d.W, H = d.H, uvh = (H + 1) / 2;
  auto Yr = [&](int r) { return &d.Y[(size_t)r * d.ys]; };
  auto Ur = [&](int r) { return &d.U[(size_t)r * d.uvs]; };
  auto Vr = [&](int r) { return &d.V[(size_t)r * d.uvs]; };
  for (int y = 0; y < H; ++y) {
    uint8_t* dst = out + (size_t)y * W * 3;
    if (y == 0) {
      upsample_row(Yr(0), Ur(0), Vr(0), Ur(0), Vr(0), dst, W);
    } else if (y & 1) {  // the top row of a pair: near = chroma row (y - 1) / 2
      const int k = (y + 1) / 2, far = k < uvh ? k : k - 1;
      upsample_row(Yr(y), Ur(k - 1), Vr(k - 1), Ur(far), Vr(far), dst, W);
    } else {  // the bottom row: near = chroma row y / 2
      const int k = y / 2;
      upsample_row(Yr(y), Ur(k), Vr(k), Ur(k - 1), Vr(k - 1), dst, W);
    }
  }
}

// ------------------------------------------------------------------ VP8L

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabetSize[5] = {256 + 24, 256, 256, 256, 40};
constexpr int kTableBits = 9;

struct LBitReader {  // LSB first
  const uint8_t* d;
  size_t n, pos = 0;  // pos in bits
  bool eos = false;
  LBitReader(const uint8_t* data, size_t len) : d(data), n(len) {}
  uint32_t peek(int k) const {  // up to 24 bits; zeros past the end
    uint32_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 4 && byte + i < n; i++) v |= (uint32_t)d[byte + i] << (8 * i);
    return (v >> (pos & 7)) & ((1u << k) - 1);
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  void skip(int k) {
    pos += (size_t)k;
    if (pos > 8 * n) eos = true;
  }
};

// a canonical prefix code: a kTableBits-bit table for short codes, the
// canonical walk for the rest
struct Huffman {
  std::vector<uint16_t> sorted;
  int count[16] = {0};
  std::vector<uint32_t> table;  // (symbol << 8) | length, 0 = longer than kTableBits
  int single = -1;

  bool build(const int* lengths, int n) {
    int nonzero = 0, last = -1;
    for (int i = 0; i < n; i++) {
      if (lengths[i] > 15) return false;
      if (lengths[i]) {
        nonzero++;
        last = i;
      }
    }
    if (nonzero == 0) return false;
    if (nonzero == 1) {  // libwebp: one symbol takes no bits, whatever its length
      single = last;
      return true;
    }
    for (int l = 0; l < 16; l++) count[l] = 0;
    for (int i = 0; i < n; i++) count[lengths[i]]++;
    count[0] = 0;
    int left = 1;
    for (int l = 1; l < 16; l++) {
      left <<= 1;
      left -= count[l];
      if (left < 0) return false;
    }
    if (left != 0) return false;  // incomplete
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
    sorted.assign(nonzero, 0);
    for (int i = 0; i < n; i++)
      if (lengths[i]) sorted[offs[lengths[i]]++] = (uint16_t)i;
    table.assign(1u << kTableBits, 0);
    int code = 0, k = 0;
    for (int l = 1; l <= 15; l++) {
      for (int c = 0; c < count[l]; c++, k++, code++) {
        if (l > kTableBits) continue;
        int rev = 0;
        for (int b = 0; b < l; b++) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int idx = rev; idx < (1 << kTableBits); idx += 1 << l) table[idx] = ((uint32_t)sorted[k] << 8) | (uint32_t)l;
      }
      code <<= 1;
    }
    return true;
  }

  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t e = table[br.peek(kTableBits)];
    if (e) {
      br.skip((int)(e & 0xff));
      return (int)(e >> 8);
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; l++) {
      code |= (int)br.read(1);
      const int c = count[l];
      if (code - first < c) return sorted[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("VP8L: bad prefix code");
  }
};

struct LDecoder {
  LBitReader br;
  unsigned transforms_seen = 0;
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };
  std::vector<Transform> transforms;

  LDecoder(const uint8_t* d, size_t n) : br(d, n) {}

  void read_code(Huffman& h, int alphabet) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code: one or two symbols
      const int num = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      int s = (int)br.read(first_bits);
      if (s >= alphabet) fail("VP8L: simple code symbol out of range");
      lengths[s] = 1;
      if (num == 2) {
        s = (int)br.read(8);
        if (s >= alphabet) fail("VP8L: simple code symbol out of range");
        lengths[s] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; i++) cl_lengths[kCodeLengthCodeOrder[i]] = (int)br.read(3);
      Huffman cl;
      if (!cl.build(cl_lengths, 19)) fail("VP8L: bad code length code");
      int max_symbol;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * (int)br.read(3);
        max_symbol = 2 + (int)br.read(length_nbits);
        if (max_symbol > alphabet) fail("VP8L: bad code length count");
      } else {
        max_symbol = alphabet;
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        const int len = cl.read(br);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len) prev = len;
        } else {
          static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
          const int slot = len - 16;
          const int repeat = (int)br.read(extra[slot]) + offset[slot];
          if (symbol + repeat > alphabet) fail("VP8L: code lengths past the alphabet");
          const int v = len == 16 ? prev : 0;
          for (int i = 0; i < repeat; i++) lengths[symbol++] = v;
        }
      }
    }
    if (br.eos || !h.build(lengths.data(), alphabet)) fail("VP8L: bad prefix code");
  }

  static int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  static int copy_value(int symbol, LBitReader& br) {  // GetCopyDistance / GetCopyLength
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  static int plane_to_distance(int xsize, int code) {
    if (code > 120) return code - 120;
    const int dist_code = kCodeToPlane[code - 1];
    const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br.read(1)) read_transform(xsize, ysize);
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("VP8L: bad colour cache size");
    }
    int meta_bits = 0, meta_w = 1, num_groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      meta_bits = (int)br.read(3) + 2;
      meta_w = sub_sample(xsize, meta_bits);
      meta = decode_stream(meta_w, sub_sample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if ((int)m + 1 > num_groups) num_groups = (int)m + 1;
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Huffman> groups((size_t)num_groups * 5);
    for (int g = 0; g < num_groups; g++)
      for (int j = 0; j < 5; j++) read_code(groups[(size_t)g * 5 + j], kAlphabetSize[j] + (j == 0 ? cache_size : 0));
    std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
    std::vector<uint32_t> px((size_t)xsize * ysize);
    const size_t total = px.size();
    size_t i = 0;
    int x = 0, y = 0;
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
    };
    while (i < total) {
      const Huffman* h = &groups[meta.empty() ? 0 : (size_t)meta[(size_t)(y >> meta_bits) * meta_w + (x >> meta_bits)] * 5];
      const int code = h[0].read(br);
      if (code < 256) {
        const int red = h[1].read(br), blue = h[2].read(br), alpha = h[3].read(br);
        if (br.eos) fail("VP8L: data ends early");
        px[i] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
        insert(px[i]);
        i++;
        if (++x >= xsize) {
          x = 0;
          y++;
        }
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256, br);
        const int dist_symbol = h[4].read(br);
        const int dist = plane_to_distance(xsize, copy_value(dist_symbol, br));
        if (br.eos) fail("VP8L: data ends early");
        if (i < (size_t)dist || total - i < (size_t)length) fail("VP8L: backward reference out of the image");
        for (int k = 0; k < length; k++, i++) {
          px[i] = px[i - dist];
          insert(px[i]);
        }
        x += length;
        while (x >= xsize) {
          x -= xsize;
          y++;
        }
      } else {
        const int key = code - 256 - 24;
        if (key >= cache_size) fail("VP8L: bad colour cache index");
        px[i] = cache[key];
        insert(px[i]);
        i++;
        if (++x >= xsize) {
          x = 0;
          y++;
        }
      }
    }
    return px;
  }

  void read_transform(int& xsize, int& ysize) {
    const int type = (int)br.read(2);
    if (transforms_seen & (1u << type)) fail("VP8L: a transform given twice");
    transforms_seen |= 1u << type;
    Transform t{type, 0, xsize, ysize, {}};
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = (int)br.read(3) + 2;
      t.data = decode_stream(sub_sample(xsize, t.bits), sub_sample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      const int num_colors = (int)br.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = sub_sample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      t.data.assign((size_t)1 << (8 >> bits), 0);
      if (t.data.size() < pal.size()) t.data.resize(256, 0);
      uint8_t* dst = (uint8_t*)t.data.data();
      const uint8_t* src = (const uint8_t*)pal.data();
      for (int k = 0; k < 4; k++) dst[k] = src[k];
      for (int k = 4; k < 4 * num_colors; k++) dst[k] = (uint8_t)(src[k] + dst[k - 4]);
    }
    transforms.push_back(std::move(t));
  }
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline int sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return abs0(pb) - abs0(pa);
}
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int d = sub3((int)(a >> 24), (int)(b >> 24), (int)(c >> 24)) +
                sub3((int)((a >> 16) & 0xff), (int)((b >> 16) & 0xff), (int)((c >> 16) & 0xff)) +
                sub3((int)((a >> 8) & 0xff), (int)((b >> 8) & 0xff), (int)((c >> 8) & 0xff)) +
                sub3((int)(a & 0xff), (int)(b & 0xff), (int)(c & 0xff));
  return d <= 0 ? a : b;
}
inline uint32_t clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= (uint32_t)clip255((int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff)) << s;
  return out;
}
inline uint32_t clamped_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
    out |= (uint32_t)clip255(a + (a - b) / 2) << s;
  }
  return out;
}

uint32_t predict_argb(int mode, uint32_t L, const uint32_t* top) {  // top points at T; TL = top[-1], TR = top[1]
  switch (mode) {
    case 1: return L;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(L, top[1]), top[0]);
    case 6: return average2(L, top[-1]);
    case 7: return average2(L, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], L, top[-1]);
    case 12: return clamped_full(L, top[0], top[-1]);
    case 13: return clamped_half(L, top[0], top[-1]);
    default: return 0xff000000u;  // 0, 14, 15: black
  }
}

void inverse_transform(const LDecoder::Transform& t, std::vector<uint32_t>& px) {
  const int W = t.xsize, H = t.ysize;
  if (t.type == 0) {  // predictor, in place, row by row
    px[0] = add_pixels(px[0], 0xff000000u);
    for (int x = 1; x < W; x++) px[x] = add_pixels(px[x], px[x - 1]);
    const int tiles_per_row = LDecoder::sub_sample(W, t.bits);
    for (int y = 1; y < H; y++) {
      uint32_t* row = &px[(size_t)y * W];
      const uint32_t* up = row - W;
      row[0] = add_pixels(row[0], up[0]);
      const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
      for (int x = 1; x < W; x++) {
        const int mode = (int)((modes[x >> t.bits] >> 8) & 0xf);
        row[x] = add_pixels(row[x], predict_argb(mode, row[x - 1], up + x));
      }
    }
  } else if (t.type == 1) {  // cross-colour
    const int tiles_per_row = LDecoder::sub_sample(W, t.bits);
    for (int y = 0; y < H; y++) {
      uint32_t* row = &px[(size_t)y * W];
      const uint32_t* codes = &t.data[(size_t)(y >> t.bits) * tiles_per_row];
      for (int x = 0; x < W; x++) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff), r2b = (int8_t)((code >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = (int8_t)(argb >> 8);
        int new_red = (int)((argb >> 16) & 0xff);
        int new_blue = (int)(argb & 0xff);
        new_red += ((int)g2r * green) >> 5;
        new_red &= 0xff;
        new_blue += ((int)g2b * green) >> 5;
        new_blue += ((int)r2b * (int8_t)new_red) >> 5;
        new_blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | (uint32_t)new_blue;
      }
    }
  } else if (t.type == 2) {  // subtract green
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else {  // colour indexing: packed indices in green, 8 >> bits bits each
    const int packed_w = LDecoder::sub_sample(W, t.bits);
    std::vector<uint32_t> out((size_t)W * H);
    const int bits_per_pixel = 8 >> t.bits, count_mask = (1 << t.bits) - 1, bit_mask = (1 << bits_per_pixel) - 1;
    for (int y = 0; y < H; y++) {
      const uint32_t* src = &px[(size_t)y * packed_w];
      uint32_t packed = 0;
      for (int x = 0; x < W; x++) {
        if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        out[(size_t)y * W + x] = t.data[packed & (uint32_t)bit_mask];
        packed >>= bits_per_pixel;
      }
    }
    px.swap(out);
  }
}

void set_err(char* err, int errlen, const std::string& m) {
  if (err && errlen > 0) snprintf(err, (size_t)errlen, "%s", m.c_str());
}

}  // namespace

extern "C" {

// a VP8 key frame (the payload of a "VP8 " chunk) → W x H x 3 RGB in out,
// W x H from the frame header
int webp_vp8(const uint8_t* data, size_t n, uint8_t* out, char* err, int errlen) {
  try {
    VP8 dec;
    dec.parse(data, n);
    dec.decode();
    emit_fancy_rgb(dec, out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

// a VP8L image (the payload of a "VP8L" chunk) → W x H x 3 RGB
int webp_vp8l(const uint8_t* data, size_t n, int w, int h, uint8_t* out, char* err, int errlen) {
  try {
    if (n < 5 || data[0] != 0x2f) fail("VP8L: bad signature");
    LDecoder dec(data + 5, n - 5);
    std::vector<uint32_t> px = dec.decode_stream(w, h, true);
    for (auto t = dec.transforms.rbegin(); t != dec.transforms.rend(); ++t) inverse_transform(*t, px);
    for (size_t i = 0; i < (size_t)w * h; i++) {
      out[3 * i] = (uint8_t)(px[i] >> 16);
      out[3 * i + 1] = (uint8_t)(px[i] >> 8);
      out[3 * i + 2] = (uint8_t)px[i];
    }
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
  }
  return 1;
}

}  // extern "C"
