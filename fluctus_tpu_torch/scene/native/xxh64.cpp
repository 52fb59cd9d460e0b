// XXH64 (Yann Collet's xxHash, 64-bit) over a file, streamed in 1 MiB
// chunks, so a large scene is never read whole into memory. Its digest
// equals the xxhash package's xxh64().hexdigest() of the file's bytes.
//
// C interface (ctypes, scene/xxh64.py):
//   int xxh64_file(const char* path, unsigned long long* out)
//     0 on success, -1 when the file cannot be opened or read.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t P3 = 0x165667B19E3779F9ULL;
constexpr uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t read64(const unsigned char* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);   // little-endian hosts
    return v;
}

inline uint32_t read32(const unsigned char* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint64_t round(uint64_t acc, uint64_t lane) {
    acc += lane * P2;
    return rotl(acc, 31) * P1;
}

inline uint64_t merge(uint64_t acc, uint64_t val) {
    acc ^= round(0, val);
    return acc * P1 + P4;
}

struct State {
    uint64_t v[4];
    uint64_t total = 0;
    unsigned char buf[32];
    size_t fill = 0;

    explicit State(uint64_t seed) {
        v[0] = seed + P1 + P2;
        v[1] = seed + P2;
        v[2] = seed;
        v[3] = seed - P1;
    }

    void stripe(const unsigned char* p) {
        for (int i = 0; i < 4; ++i) v[i] = round(v[i], read64(p + 8 * i));
    }

    void update(const unsigned char* p, size_t n) {
        total += n;
        if (fill) {
            size_t take = n < 32 - fill ? n : 32 - fill;
            std::memcpy(buf + fill, p, take);
            fill += take;
            p += take;
            n -= take;
            if (fill < 32) return;
            stripe(buf);
            fill = 0;
        }
        while (n >= 32) {
            stripe(p);
            p += 32;
            n -= 32;
        }
        std::memcpy(buf, p, n);
        fill = n;
    }

    uint64_t digest(uint64_t seed) const {
        uint64_t h;
        if (total >= 32) {
            h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
            for (int i = 0; i < 4; ++i) h = merge(h, v[i]);
        } else {
            h = seed + P5;
        }
        h += total;
        const unsigned char* p = buf;
        size_t n = fill;
        while (n >= 8) {
            h = rotl(h ^ round(0, read64(p)), 27) * P1 + P4;
            p += 8;
            n -= 8;
        }
        if (n >= 4) {
            h = rotl(h ^ (uint64_t(read32(p)) * P1), 23) * P2 + P3;
            p += 4;
            n -= 4;
        }
        while (n--) {
            h = rotl(h ^ (uint64_t(*p++) * P5), 11) * P1;
        }
        h ^= h >> 33;
        h *= P2;
        h ^= h >> 29;
        h *= P3;
        h ^= h >> 32;
        return h;
    }
};

}  // namespace

extern "C" int xxh64_file(const char* path, unsigned long long* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    State s(0);
    std::vector<unsigned char> chunk(1 << 20);
    size_t got;
    while ((got = std::fread(chunk.data(), 1, chunk.size(), f)) > 0)
        s.update(chunk.data(), got);
    bool bad = std::ferror(f) != 0;
    std::fclose(f);
    if (bad) return -1;
    *out = s.digest(0);
    return 0;
}
