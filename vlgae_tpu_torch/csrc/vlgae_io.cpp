// vlgae_io: the det-feature packer of the PyTorch port (the functions of
// the JAX package's native/vlgae_io.cpp, with the same results).
//
// Per-image .npy feature files [n_box, feat_dim + 4] are parsed, `sample`
// boxes are drawn (a partial Fisher-Yates shuffle on std::mt19937_64
// seeded with seed + i for the i-th image, the drawn rows sorted), and
// padded batches are packed straight into caller-allocated buffers.
// Exposed through a C ABI for ctypes. A file is opened once and the rows
// from the first drawn to the last are read in one call: a read a row costs
// a system call each, which dominates the packing on hosts where system
// calls are slow.
//
// Also provides a fast CoNLL tokenizer (block splitting + column
// extraction).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <vector>

// The .npy header of an open file (read from its start); the codes of
// vlgae_npy_header. The file stays open.
static int npy_header(FILE* f, int64_t* rows, int64_t* cols,
                      int64_t* data_offset, int* dtype_size) {
    unsigned char magic[8];
    if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
        return -2;
    }
    int major = magic[6];
    uint32_t header_len = 0;
    if (major == 1) {
        unsigned char b[2];
        if (std::fread(b, 1, 2, f) != 2) return -3;
        header_len = b[0] | (b[1] << 8);
        *data_offset = 10 + header_len;
    } else {
        unsigned char b[4];
        if (std::fread(b, 1, 4, f) != 4) return -3;
        header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
        *data_offset = 12 + header_len;
    }
    std::string header(header_len, '\0');
    if (std::fread(&header[0], 1, header_len, f) != header_len) return -3;
    if (header.find("'fortran_order': True") != std::string::npos) return -4;
    size_t dt = header.find("'descr':");
    *dtype_size = 4;
    if (dt != std::string::npos) {
        // big-endian data would parse to garbage floats; reject it
        // (numpy writes '<f4'/'<f8' on every supported platform)
        if (header.find("'>f", dt) != std::string::npos) return -5;
        if (header.find("f8", dt) != std::string::npos) *dtype_size = 8;
        else if (header.find("f4", dt) != std::string::npos) *dtype_size = 4;
        else return -5;
    }
    size_t sh = header.find("'shape':");
    if (sh == std::string::npos) return -6;
    size_t open = header.find('(', sh);
    if (open == std::string::npos) return -6;
    size_t close = header.find(')', open);
    // a truncated header must return an error code, not throw
    // std::out_of_range through the C ABI (ctypes would crash)
    if (close == std::string::npos) return -6;
    std::string shape = header.substr(open + 1, close - open - 1);
    long long r = 0, c = 1;
    if (std::sscanf(shape.c_str(), "%lld , %lld", &r, &c) < 1) {
        if (std::sscanf(shape.c_str(), "%lld, %lld", &r, &c) < 1) return -7;
    }
    *rows = r;
    *cols = c;
    return 0;
}

extern "C" {

// Parse a .npy header. Returns 0 on success; fills rows/cols/data_offset.
// Only supports C-order little-endian f4/f8 2-D arrays (what the
// detection-feature dumps use).
int vlgae_npy_header(const char* path, int64_t* rows, int64_t* cols,
                     int64_t* data_offset, int* dtype_size) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int rc = npy_header(f, rows, cols, data_offset, dtype_size);
    std::fclose(f);
    return rc;
}

// Load one .npy feature file [n_box, feat_dim + 4] into caller buffers,
// optionally subsampling `sample` boxes (seeded, without replacement).
// feats_out: [pad_boxes, feat_dim] f32; boxes_out: [pad_boxes, 4] f32;
// mask_out: [pad_boxes] u8. Returns number of boxes written, < 0 on error.
int vlgae_load_det_feats(const char* path, int64_t pad_boxes,
                         int64_t feat_dim, int64_t sample, uint64_t seed,
                         float* feats_out, float* boxes_out,
                         uint8_t* mask_out) {
    int64_t rows, cols, offset;
    int dtype_size;
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int rc = npy_header(f, &rows, &cols, &offset, &dtype_size);
    if (rc == 0 && cols != feat_dim + 4) rc = -8;
    if (rc != 0) {
        std::fclose(f);
        return rc;
    }
    std::vector<int64_t> sel;
    if (sample > 0 && sample < rows) {
        std::mt19937_64 rng(seed);
        std::vector<int64_t> idx(rows);
        for (int64_t i = 0; i < rows; ++i) idx[i] = i;
        for (int64_t i = 0; i < sample; ++i) {
            std::uniform_int_distribution<int64_t> d(i, rows - 1);
            std::swap(idx[i], idx[d(rng)]);
        }
        sel.assign(idx.begin(), idx.begin() + sample);
        std::sort(sel.begin(), sel.end());
    } else {
        int64_t n = std::min(rows, pad_boxes);
        for (int64_t i = 0; i < n; ++i) sel.push_back(i);
    }
    int64_t n = std::min<int64_t>(sel.size(), pad_boxes);

    std::memset(mask_out, 0, pad_boxes);
    std::memset(feats_out, 0, sizeof(float) * pad_boxes * feat_dim);
    std::memset(boxes_out, 0, sizeof(float) * pad_boxes * 4);

    // the drawn rows are sorted: read from the first to the last at once
    const int64_t row_bytes = cols * dtype_size;
    std::vector<char> span;
    if (n > 0) {
        span.resize((sel[n - 1] - sel[0] + 1) * row_bytes);
        if (std::fseek(f, offset + sel[0] * row_bytes, SEEK_SET)
            || std::fread(span.data(), 1, span.size(), f) != span.size()) {
            std::fclose(f);
            return -9;
        }
    }
    std::vector<double> row_d(cols);
    std::vector<float> row_f(cols);
    for (int64_t i = 0; i < n; ++i) {
        const char* row = span.data() + (sel[i] - sel[0]) * row_bytes;
        if (dtype_size == 8) {
            std::memcpy(row_d.data(), row, row_bytes);
            for (int64_t j = 0; j < cols; ++j) row_f[j] = (float)row_d[j];
        } else {
            std::memcpy(row_f.data(), row, row_bytes);
        }
        std::memcpy(feats_out + i * feat_dim, row_f.data(),
                    sizeof(float) * feat_dim);
        std::memcpy(boxes_out + i * 4, row_f.data() + feat_dim,
                    sizeof(float) * 4);
        mask_out[i] = 1;
    }
    std::fclose(f);
    return (int)n;
}

// Batched variant: loads n_imgs files (paths as a \n-joined buffer).
// Outputs are [n_imgs, pad_boxes, ...] contiguous. Returns 0 on success.
int vlgae_load_det_feats_batch(const char* paths_joined, int64_t n_imgs,
                               int64_t pad_boxes, int64_t feat_dim,
                               int64_t sample, uint64_t seed,
                               float* feats_out, float* boxes_out,
                               uint8_t* mask_out) {
    const char* p = paths_joined;
    for (int64_t i = 0; i < n_imgs; ++i) {
        const char* end = std::strchr(p, '\n');
        std::string path = end ? std::string(p, end - p) : std::string(p);
        int rc = vlgae_load_det_feats(
            path.c_str(), pad_boxes, feat_dim, sample, seed + (uint64_t)i,
            feats_out + i * pad_boxes * feat_dim,
            boxes_out + i * pad_boxes * 4, mask_out + i * pad_boxes);
        if (rc < 0) return rc;
        if (!end) break;
        p = end + 1;
    }
    return 0;
}

// Fast CoNLL pass: counts sentences and tokens so Python can preallocate;
// returns number of sentences, fills total_tokens.
int64_t vlgae_conll_count(const char* text, int64_t len,
                          int64_t* total_tokens) {
    int64_t sents = 0, toks = 0;
    bool in_sent = false, line_has_content = false;
    for (int64_t i = 0; i < len; ++i) {
        char c = text[i];
        if (c == '\n') {
            if (line_has_content) {
                ++toks;
                in_sent = true;
            } else if (in_sent) {
                ++sents;
                in_sent = false;
            }
            line_has_content = false;
        } else if (c != '\r' && c != ' ' && c != '\t') {
            line_has_content = true;
        }
    }
    if (line_has_content) { ++toks; in_sent = true; }
    if (in_sent) ++sents;
    *total_tokens = toks;
    return sents;
}

}  // extern "C"
