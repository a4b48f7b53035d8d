// Native beam-search decoder core: ARPA n-gram LM + lexicon trie +
// CTC/ASG token-passing beam search.
//
// This is the TPU framework's equivalent of the reference's native decoder
// stack (fl::lib::text: KenLM wrapper, Trie, LexiconDecoder /
// LexiconFreeDecoder — call sites cpc/Decode.cpp:242-624 and
// inference/decoder/Decoder.cpp). Semantics intentionally match the Python
// implementation in wav2letter_tpu/decoder/ (beam.py, lm.py, trie.py) —
// the two are differentially tested; this core exists because beam search
// is pointer-chasing host code where C++ is ~100x Python.
//
// Exposed as a C API consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// Read-only file mapping. KenLM binaries are DESIGNED for mmap (the magic
// string literally reads "mmap lm ..."); the reference loads its 3 GB
// 4-gram this way — O(1) startup, pages fault in on demand, clean pages
// evictable under memory pressure. `slack` extra zero bytes are guaranteed
// readable past EOF (the .qt bit-packed reader loads up to 8 bytes beyond
// the last record): an anonymous zero mapping is reserved first and the
// file is mapped MAP_FIXED over its prefix, so the tail stays zero-filled.
// Falls back to a heap read if mmap is unavailable.
// ---------------------------------------------------------------------------
struct MappedFile {
  const char* base = nullptr;
  size_t size = 0;          // file bytes
  size_t map_len = 0;       // mapped bytes (0 => heap fallback)
  std::vector<char> heap;   // fallback storage
  bool used_mmap = false;

  MappedFile() = default;
  MappedFile(const MappedFile&) = delete;
  MappedFile& operator=(const MappedFile&) = delete;
  ~MappedFile() { reset(); }

  void reset() {
    if (base && map_len) munmap(const_cast<char*>(base), map_len);
    base = nullptr;
    map_len = 0;
    size = 0;
    heap.clear();
    used_mmap = false;
  }

  bool open(const std::string& path, size_t slack = 8) {
    reset();
    int fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) {
      ::close(fd);
      return false;
    }
    size = (size_t)st.st_size;
    size_t page = (size_t)sysconf(_SC_PAGESIZE);
    map_len = ((size + slack + page - 1) / page) * page;
    void* anon = mmap(nullptr, map_len, PROT_READ,
                      MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (anon != MAP_FAILED) {
      void* m = mmap(anon, size, PROT_READ, MAP_PRIVATE | MAP_FIXED, fd, 0);
      if (m != MAP_FAILED) {
        base = (const char*)anon;
        used_mmap = true;
        ::close(fd);
        return true;
      }
      munmap(anon, map_len);
    }
    // fallback: whole-file heap read (+ zero slack)
    map_len = 0;
    heap.assign(size + slack, 0);
    ssize_t got = 0;
    size_t off = 0;
    while (off < size && (got = pread(fd, heap.data() + off, size - off, off)) > 0)
      off += (size_t)got;
    ::close(fd);
    if (off != size) {
      reset();
      return false;
    }
    base = heap.data();
    return true;
  }

  const char* data() const { return base; }
};

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kInf = std::numeric_limits<double>::infinity();

static inline double logadd(double a, double b) {
  if (a < b) std::swap(a, b);
  if (b == kNegInf) return a;
  return a + std::log1p(std::exp(b - a));
}

// ---------------------------------------------------------------------------
// LM interface: ARPA text or KenLM probing binary, both scoring log10 with
// the standard backoff chain (KenLM convention; fl::lib::text::KenLM parity).
// ---------------------------------------------------------------------------
struct LMBase {
  int order = 0;
  int unk_id = -1, bos_id = -1, eos_id = -1;
  virtual ~LMBase() = default;
  // (prob, backoff) of the exact n-gram ids[0..n) (ids[0] oldest); false if absent
  virtual bool lookup_pb(const int32_t* ids, int n, float* p, float* b) const = 0;
  virtual int find_word(const std::string& w) const = 0;  // -1 / unk if absent
  // 1 = file-backed via mmap, 0 = heap copy, -1 = not a binary container
  virtual int used_mmap() const { return -1; }

  // log10 P(w | hist) with backoff; hist length <= order-1
  float score(const int32_t* hist, int hn, int32_t w) const {
    if (w < 0) w = unk_id;  // OOV -> <unk>, then the normal backoff chain
    if (w < 0) return -10.f;
    float total_bo = 0.f, p, b;
    int start = std::max(0, hn - (order - 1));
    std::vector<int32_t> buf(hist + start, hist + hn);
    while (true) {
      buf.push_back(w);
      bool found = lookup_pb(buf.data(), (int)buf.size(), &p, &b);
      buf.pop_back();
      if (found) return p + total_bo;
      if (buf.empty()) {
        if (lookup_pb(&w, 1, &p, &b)) return p + total_bo;
        if (unk_id >= 0) {
          int32_t uu = unk_id;
          if (lookup_pb(&uu, 1, &p, &b)) return p + total_bo;
        }
        return -10.f + total_bo;
      }
      if (lookup_pb(buf.data(), (int)buf.size(), &p, &b)) total_bo += b;
      buf.erase(buf.begin());
    }
  }
};

// ---------------------------------------------------------------------------
// ARPA n-gram text reader
// ---------------------------------------------------------------------------
struct NgramLM : LMBase {
  std::unordered_map<std::string, int> vocab;
  // per-order maps: key = packed int32 word ids
  std::vector<std::unordered_map<std::string, std::pair<float, float>>> tables;

  static std::string key(const int32_t* ids, int n) {
    return std::string(reinterpret_cast<const char*>(ids), n * sizeof(int32_t));
  }

  int word_id(const std::string& w) {
    auto it = vocab.find(w);
    if (it != vocab.end()) return it->second;
    int id = (int)vocab.size();
    vocab.emplace(w, id);
    return id;
  }

  bool load_arpa(const std::string& path) {
    std::ifstream f(path);
    if (!f) return false;
    std::string line;
    int section = -1;  // -1 none, 0 data, n>=1 grams
    while (std::getline(f, line)) {
      // trim \r
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
        line.pop_back();
      if (line.empty()) continue;
      if (line.rfind("\\data\\", 0) == 0) { section = 0; continue; }
      if (line[0] == '\\' && line.find("-grams:") != std::string::npos) {
        section = std::stoi(line.substr(1, line.find('-') - 1));
        while ((int)tables.size() < section) tables.emplace_back();
        continue;
      }
      if (line.rfind("\\end\\", 0) == 0) break;
      if (section <= 0) continue;
      // parse: logp \t w1 w2 ... \t [backoff]   (tabs or spaces)
      std::istringstream ss(line);
      float logp;
      if (!(ss >> logp)) continue;
      std::vector<int32_t> ids(section);
      std::string w;
      bool ok = true;
      for (int i = 0; i < section; i++) {
        if (!(ss >> w)) { ok = false; break; }
        ids[i] = word_id(w);
      }
      if (!ok) continue;
      float bo = 0.f;
      ss >> bo;  // absent -> stays 0
      tables[section - 1].emplace(key(ids.data(), section), std::make_pair(logp, bo));
    }
    order = (int)tables.size();
    auto it = vocab.find("<unk>");
    unk_id = it == vocab.end() ? -1 : it->second;
    it = vocab.find("<s>");
    bos_id = it == vocab.end() ? -1 : it->second;
    it = vocab.find("</s>");
    eos_id = it == vocab.end() ? -1 : it->second;
    return order > 0;
  }

  bool lookup_pb(const int32_t* ids, int n, float* p, float* b) const override {
    if (n < 1 || n > order) return false;
    auto& t = tables[n - 1];
    auto it = t.find(key(ids, n));
    if (it == t.end()) return false;
    *p = it->second.first;
    *b = it->second.second;
    return true;
  }

  int find_word(const std::string& w) const override {
    auto it = vocab.find(w);
    return it == vocab.end() ? -1 : it->second;
  }
};

// ---------------------------------------------------------------------------
// KenLM binary, PROBING format — reader + writer.
//
// Layout reconstructed from the public KenLM sources (lm/binary_format.cc,
// lm/vocab.cc, lm/search_hashed.hh, util/probing_hash_table.hh); the
// reference decodes with these files (--lm=*.bin, e.g.
// recipes/streaming_convnets/librispeech/prepare_lms.sh builds them).
// Reader + writer are round-trip tested against the ARPA path; TRIE /
// quantized (.qt) variants are rejected with a clear error (use probing or
// ARPA). Scores are log10, as stored.
// ---------------------------------------------------------------------------

// MurmurHash64A (public domain, Austin Appleby) — KenLM's HashForVocab
// (util/murmur_hash.cc) with seed 0 on 64-bit little-endian.
static uint64_t murmur64a(const void* key, size_t len, uint64_t seed = 0) {
  const uint64_t m = 0xc6a4a7935bd1e995ULL;
  const int r = 47;
  uint64_t h = seed ^ (len * m);
  const unsigned char* data = static_cast<const unsigned char*>(key);
  const unsigned char* end = data + (len & ~size_t(7));
  while (data != end) {
    uint64_t k;
    std::memcpy(&k, data, 8);
    data += 8;
    k *= m; k ^= k >> r; k *= m;
    h ^= k; h *= m;
  }
  uint64_t tail = 0;
  switch (len & 7) {
    case 7: tail ^= uint64_t(data[6]) << 48; [[fallthrough]];
    case 6: tail ^= uint64_t(data[5]) << 40; [[fallthrough]];
    case 5: tail ^= uint64_t(data[4]) << 32; [[fallthrough]];
    case 4: tail ^= uint64_t(data[3]) << 24; [[fallthrough]];
    case 3: tail ^= uint64_t(data[2]) << 16; [[fallthrough]];
    case 2: tail ^= uint64_t(data[1]) << 8;  [[fallthrough]];
    case 1: tail ^= uint64_t(data[0]);
            h ^= tail; h *= m;
  }
  h ^= h >> r; h *= m; h ^= h >> r;
  return h;
}

// lm/search_hashed.hh detail::CombineWordHash
static inline uint64_t combine_word_hash(uint64_t cur, uint32_t next) {
  return (cur * 8978948897894561157ULL) ^
         ((uint64_t)(1 + next) * 17894857484156487943ULL);
}

// n-gram key: start from the NEWEST word, extend left through the context
// (KenLM LookupUnigram sets node=word then LookupMiddle combines leftwards).
static uint64_t kenlm_ngram_hash(const int32_t* ids, int n) {
  uint64_t h = (uint32_t)ids[n - 1];
  for (int i = n - 2; i >= 0; --i) h = combine_word_hash(h, (uint32_t)ids[i]);
  return h;
}

static inline uint64_t align8(uint64_t x) { return (x + 7) & ~uint64_t(7); }

static const char kKenlmMagicPrefix[] =
    "mmap lm http://kheafield.com/code format version";
static const char kKenlmMagicBytes[] =
    "mmap lm http://kheafield.com/code format version 5\n";

#pragma pack(push, 1)
struct KenlmSanity {  // lm/binary_format.cc struct Sanity (88 bytes)
  char magic[56];     // ALIGN8(sizeof(kMagicBytes)) incl. trailing NULs
  float zero_f, one_f, minus_half_f;
  uint32_t one_word_index, max_word_index;
  uint32_t pad_;
  uint64_t one_uint64;
};
struct KenlmFixedParams {  // lm/binary_format.hh FixedWidthParameters (20 bytes)
  unsigned char order;
  unsigned char pad_[3];
  float probing_multiplier;
  int32_t model_type;  // 0 PROBING, 1 REST_PROBING, 2 TRIE, 3.. quantized
  unsigned char has_vocabulary;
  unsigned char pad2_[3];
  uint32_t search_version;
};
struct KenlmProbBackoff { float prob, backoff; };
struct KenlmMiddleEntry { uint64_t key; KenlmProbBackoff pb; };
struct KenlmLongestEntry { uint64_t key; float prob; uint32_t pad_; };
struct KenlmVocabEntry { uint64_t key; uint32_t value; uint32_t pad_; };
#pragma pack(pop)
static_assert(sizeof(KenlmSanity) == 88, "kenlm Sanity layout");
static_assert(sizeof(KenlmFixedParams) == 20, "kenlm params layout");
static_assert(sizeof(KenlmMiddleEntry) == 16 && sizeof(KenlmLongestEntry) == 16 &&
              sizeof(KenlmVocabEntry) == 16, "kenlm entry layout");

static uint64_t probing_buckets(uint64_t entries, float multiplier) {
  return std::max<uint64_t>(entries + 1, (uint64_t)(multiplier * (float)entries));
}

template <class E>
static const E* probe_find(const E* table, uint64_t buckets, uint64_t key) {
  if (!buckets || key == 0) return nullptr;  // key 0 marks empty buckets
  uint64_t i = key % buckets;
  for (uint64_t n = 0; n < buckets; ++n) {
    const E& e = table[i];
    if (e.key == key) return &e;
    if (e.key == 0) return nullptr;
    if (++i == buckets) i = 0;
  }
  return nullptr;
}

template <class E>
static void probe_insert(E* table, uint64_t buckets, const E& entry) {
  uint64_t i = entry.key % buckets;
  while (table[i].key != 0) {
    if (table[i].key == entry.key) { table[i] = entry; return; }
    if (++i == buckets) i = 0;
  }
  table[i] = entry;
}

struct KenlmBinaryLM : LMBase {
  MappedFile map;  // mmap'd file; tables are pointers into it
  int used_mmap() const override { return map.used_mmap ? 1 : 0; }
  const KenlmProbBackoff* unigram = nullptr;
  uint64_t n_unigram = 0;  // valid ids are [0, n_unigram)
  struct Mid { const KenlmMiddleEntry* t; uint64_t buckets; };
  std::vector<Mid> middles;
  const KenlmLongestEntry* longest = nullptr;
  uint64_t longest_buckets = 0;
  const KenlmVocabEntry* vocab_table = nullptr;
  uint64_t vocab_buckets = 0;
  std::string error;

  bool load(const std::string& path) {
    if (!map.open(path)) { error = "cannot open " + path; return false; }
    const char* buf_data = map.data();
    const size_t buf_size = map.size;
    if (buf_size < sizeof(KenlmSanity) + sizeof(KenlmFixedParams)) {
      error = "file too small for kenlm binary";
      return false;
    }
    if (std::memcmp(buf_data, kKenlmMagicPrefix, sizeof(kKenlmMagicPrefix) - 1)) {
      error = "bad kenlm magic";
      return false;
    }
    if (buf_data[sizeof(kKenlmMagicPrefix)] != '5') {
      error = "unsupported kenlm binary format version (need 5)";
      return false;
    }
    KenlmFixedParams prm;
    std::memcpy(&prm, buf_data + sizeof(KenlmSanity), sizeof(prm));
    if (prm.model_type != 0) {
      error = "kenlm model type " + std::to_string(prm.model_type) +
              " unsupported (only PROBING; rebuild with `build_binary probing` "
              "or use the .arpa text)";
      return false;
    }
    order = prm.order;
    if (order < 1 || order > 16) { error = "bad order"; return false; }
    std::vector<uint64_t> counts(order);
    uint64_t off = sizeof(KenlmSanity) + sizeof(KenlmFixedParams);
    if (buf_size < off + 8 * order) { error = "truncated header"; return false; }
    std::memcpy(counts.data(), buf_data + off, 8 * order);
    off = align8(off + 8 * order);  // TotalHeaderSize

    // ProbingVocabulary: ALIGN8(header{uint64 bound}) + hash table
    if (buf_size < off + 8) { error = "truncated vocab header"; return false; }
    off += align8(8);
    vocab_buckets = probing_buckets(counts[0], prm.probing_multiplier);
    vocab_table = reinterpret_cast<const KenlmVocabEntry*>(buf_data + off);
    off += vocab_buckets * sizeof(KenlmVocabEntry);

    // HashedSearch: unigram array, middles, longest
    n_unigram = counts[0] + 1;
    unigram = reinterpret_cast<const KenlmProbBackoff*>(buf_data + off);
    off += n_unigram * sizeof(KenlmProbBackoff);
    for (int o = 2; o < order; ++o) {
      uint64_t bk = probing_buckets(counts[o - 1], prm.probing_multiplier);
      middles.push_back({reinterpret_cast<const KenlmMiddleEntry*>(buf_data + off), bk});
      off += bk * sizeof(KenlmMiddleEntry);
    }
    if (order > 1) {
      longest_buckets = probing_buckets(counts[order - 1], prm.probing_multiplier);
      longest = reinterpret_cast<const KenlmLongestEntry*>(buf_data + off);
      off += longest_buckets * sizeof(KenlmLongestEntry);
    }
    if (buf_size < off) { error = "truncated tables"; return false; }

    unk_id = 0;  // kenlm convention: <unk> is always id 0
    bos_id = find_word("<s>");
    eos_id = find_word("</s>");
    return true;
  }

  int find_word(const std::string& w) const override {
    if (w == "<unk>" || w == "<UNK>") return 0;
    auto* e = probe_find(vocab_table, vocab_buckets, murmur64a(w.data(), w.size()));
    return e ? (int)e->value : 0;  // kenlm: OOV -> 0 (<unk>)
  }

  bool lookup_pb(const int32_t* ids, int n, float* p, float* b) const override {
    if (n < 1 || n > order) return false;
    if (n == 1) {
      uint32_t w = (ids[0] < 0 || (uint64_t)ids[0] >= n_unigram) ? 0 : (uint32_t)ids[0];
      *p = unigram[w].prob;
      *b = unigram[w].backoff;
      return true;
    }
    uint64_t h = kenlm_ngram_hash(ids, n);
    if (n == order) {
      auto* e = probe_find(longest, longest_buckets, h);
      if (!e) return false;
      *p = e->prob;
      *b = 0.f;
      return true;
    }
    auto* e = probe_find(middles[n - 2].t, middles[n - 2].buckets, h);
    if (!e) return false;
    *p = e->pb.prob;
    *b = e->pb.backoff;
    return true;
  }
};

// build_binary equivalent: ARPA text -> kenlm PROBING binary.
struct ArpaGram { std::vector<int32_t> ids; float p, bo; };

struct ArpaGrams {
  int order = 0;
  std::vector<std::vector<ArpaGram>> grams;  // per order
  std::vector<std::string> words_by_id{"<unk>"};
  bool saw_unk = false;
};

static bool parse_arpa_grams(const std::string& arpa, ArpaGrams* out,
                             std::string* err) {
  std::ifstream f(arpa);
  if (!f) { *err = "cannot open " + arpa; return false; }
  std::string line;
  int section = -1;
  std::unordered_map<std::string, uint32_t> vocab;  // kenlm ids: <unk>=0
  auto& grams = out->grams;
  auto& words_by_id = out->words_by_id;
  while (std::getline(f, line)) {
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line.empty()) continue;
    if (line.rfind("\\data\\", 0) == 0) { section = 0; continue; }
    if (line[0] == '\\' && line.find("-grams:") != std::string::npos) {
      section = std::stoi(line.substr(1, line.find('-') - 1));
      while ((int)grams.size() < section) grams.emplace_back();
      continue;
    }
    if (line.rfind("\\end\\", 0) == 0) break;
    if (section <= 0) continue;
    std::istringstream ss(line);
    float logp;
    if (!(ss >> logp)) continue;
    ArpaGram g;
    g.ids.resize(section);
    g.p = logp;
    g.bo = 0.f;
    std::string w;
    bool ok = true;
    for (int i = 0; i < section; i++) {
      if (!(ss >> w)) { ok = false; break; }
      if (section == 1) {  // assign ids in unigram order, kenlm-style
        if (w == "<unk>" || w == "<UNK>") { out->saw_unk = true; g.ids[i] = 0; }
        else {
          auto it = vocab.find(w);
          if (it == vocab.end()) {
            uint32_t id = (uint32_t)words_by_id.size();
            vocab.emplace(w, id);
            words_by_id.push_back(w);
            g.ids[i] = (int32_t)id;
          } else g.ids[i] = (int32_t)it->second;
        }
      } else {
        if (w == "<unk>" || w == "<UNK>") g.ids[i] = 0;
        else {
          auto it = vocab.find(w);
          g.ids[i] = it == vocab.end() ? 0 : (int32_t)it->second;
        }
      }
    }
    if (!ok) continue;
    ss >> g.bo;
    grams[section - 1].push_back(std::move(g));
  }
  out->order = (int)grams.size();
  if (out->order < 1) { *err = "no n-gram sections in " + arpa; return false; }
  return true;
}

static bool kenlm_build_binary(const std::string& arpa, const std::string& out,
                               float multiplier, std::string* err) {
  ArpaGrams ag;
  if (!parse_arpa_grams(arpa, &ag, err)) return false;
  int order = ag.order;
  auto& grams = ag.grams;
  auto& words_by_id = ag.words_by_id;
  bool saw_unk = ag.saw_unk;
  std::vector<uint64_t> counts(order);
  for (int o = 0; o < order; ++o) counts[o] = grams[o].size();
  if (!saw_unk) counts[0] += 1;  // implicit <unk> slot

  // layout
  uint64_t header_sz = align8(sizeof(KenlmSanity) + sizeof(KenlmFixedParams) + 8 * order);
  uint64_t vocab_buckets = probing_buckets(counts[0], multiplier);
  uint64_t vocab_sz = align8(8) + vocab_buckets * sizeof(KenlmVocabEntry);
  uint64_t uni_sz = (counts[0] + 1) * sizeof(KenlmProbBackoff);
  std::vector<uint64_t> mid_buckets;
  uint64_t mid_sz = 0;
  for (int o = 2; o < order; ++o) {
    mid_buckets.push_back(probing_buckets(counts[o - 1], multiplier));
    mid_sz += mid_buckets.back() * sizeof(KenlmMiddleEntry);
  }
  uint64_t long_buckets = order > 1 ? probing_buckets(counts[order - 1], multiplier) : 0;
  uint64_t long_sz = long_buckets * sizeof(KenlmLongestEntry);
  std::vector<char> out_buf(header_sz + vocab_sz + uni_sz + mid_sz + long_sz, 0);

  // header
  KenlmSanity sanity;
  std::memset(&sanity, 0, sizeof(sanity));
  std::memcpy(sanity.magic, kKenlmMagicBytes, sizeof(kKenlmMagicBytes));
  sanity.zero_f = 0.f; sanity.one_f = 1.f; sanity.minus_half_f = -0.5f;
  sanity.one_word_index = 1;
  sanity.max_word_index = std::numeric_limits<uint32_t>::max();
  sanity.pad_ = 0;
  sanity.one_uint64 = 1;
  std::memcpy(out_buf.data(), &sanity, sizeof(sanity));
  KenlmFixedParams prm;
  std::memset(&prm, 0, sizeof(prm));
  prm.order = (unsigned char)order;
  prm.probing_multiplier = multiplier;
  prm.model_type = 0;  // PROBING
  prm.has_vocabulary = 1;
  prm.search_version = 0;
  std::memcpy(out_buf.data() + sizeof(sanity), &prm, sizeof(prm));
  std::memcpy(out_buf.data() + sizeof(sanity) + sizeof(prm), counts.data(), 8 * order);

  // vocab
  uint64_t off = header_sz;
  uint64_t bound = words_by_id.size();  // ids are [0, bound)
  std::memcpy(out_buf.data() + off, &bound, 8);
  off += align8(8);
  auto* vt = reinterpret_cast<KenlmVocabEntry*>(out_buf.data() + off);
  for (uint32_t id = 1; id < (uint32_t)words_by_id.size(); ++id) {
    const std::string& w = words_by_id[id];
    probe_insert(vt, vocab_buckets, KenlmVocabEntry{murmur64a(w.data(), w.size()), id, 0});
  }
  off += vocab_buckets * sizeof(KenlmVocabEntry);

  // unigrams (dense by id); default <unk> if absent from the ARPA
  auto* uni = reinterpret_cast<KenlmProbBackoff*>(out_buf.data() + off);
  uni[0] = {-10.f, 0.f};
  for (const auto& g : grams[0]) uni[(uint32_t)g.ids[0]] = {g.p, g.bo};
  off += uni_sz;

  // middle orders
  for (int o = 2; o < order; ++o) {
    auto* t = reinterpret_cast<KenlmMiddleEntry*>(out_buf.data() + off);
    uint64_t bk = mid_buckets[o - 2];
    for (const auto& g : grams[o - 1])
      probe_insert(t, bk, KenlmMiddleEntry{kenlm_ngram_hash(g.ids.data(), o), {g.p, g.bo}});
    off += bk * sizeof(KenlmMiddleEntry);
  }
  // longest order (prob only)
  if (order > 1) {
    auto* t = reinterpret_cast<KenlmLongestEntry*>(out_buf.data() + off);
    for (const auto& g : grams[order - 1])
      probe_insert(t, long_buckets,
                   KenlmLongestEntry{kenlm_ngram_hash(g.ids.data(), order), g.p, 0});
    off += long_sz;
  }

  std::ofstream of(out, std::ios::binary);
  if (!of) { *err = "cannot write " + out; return false; }
  of.write(out_buf.data(), out_buf.size());
  // vocabulary strings, null-terminated in id order (kenlm has_vocabulary tail)
  for (const auto& w : words_by_id) of.write(w.c_str(), w.size() + 1);
  return (bool)of;
}

// ---------------------------------------------------------------------------
// Quantized trie n-gram binary ("qt") — the small-footprint decode format.
//
// Design follows kenlm's TRIE/QUANT_TRIE search structure (the reference
// publishes streaming_convnets decode WERs with 13MB `.qt` models,
// `recipes/streaming_convnets/librispeech/prepare_lms.sh`): a sorted
// suffix trie — the n-gram (w1..wn) is stored on the path wn -> w(n-1) ->
// ... -> w1 so backoff lookups share prefixes — with bit-packed records
// {word, prob8, backoff8, child-pointer}, 8-bit equal-population
// quantization codebooks per order, and full-precision unigrams.
// Real-kenlm `.qt` byte-compat cannot be validated in this environment
// (no kenlm, zero egress); kenlm trie files keep being rejected with a
// clear error, while this container is self-describing ("W2LQT\2") with
// round-trip, quantization-error-bound, and differential-decode tests.
//
// Version 2 (over v1): (a) completion-only trie nodes — suffix paths that
// exist only so deeper n-grams are reachable, the case kenlm's BlankManager
// handles for pruned ARPAs — are marked with the reserved prob code 255 so
// lookup_pb reports them absent at full depth and LMBase::score backs off
// (v1 returned their placeholder p=-99, silently corrupting scores for
// pruned ARPA inputs such as 3-gram.pruned.*); their placeholder values are
// also excluded from the prob codebooks. (b) 4 bytes of padding after the
// order field align the vocab hash array to 8 bytes (v1 did misaligned
// uint64 loads — UB under strict-alignment/UBSan).
// ---------------------------------------------------------------------------
static const char kQtMagic[8] = {'W', '2', 'L', 'Q', 'T', 2, 0, 0};
// Reserved prob code marking a completion-only (pseudo) node: "no n-gram of
// this length ends here", triggering backoff in LMBase::score.
constexpr uint8_t kQtPseudoCode = 255;

static inline uint64_t read_bits(const uint8_t* base, uint64_t bit_off, int bits) {
  uint64_t v;
  std::memcpy(&v, base + (bit_off >> 3), 8);  // caller guarantees 8B slack
  return (v >> (bit_off & 7)) & ((bits == 64) ? ~0ull : ((1ull << bits) - 1));
}

static inline void write_bits(std::vector<uint8_t>& buf, uint64_t bit_off,
                              uint64_t val, int bits) {
  uint64_t v;
  uint8_t* base = buf.data() + (bit_off >> 3);
  std::memcpy(&v, base, 8);
  uint64_t mask = ((bits == 64) ? ~0ull : ((1ull << bits) - 1)) << (bit_off & 7);
  v = (v & ~mask) | ((val << (bit_off & 7)) & mask);
  std::memcpy(base, &v, 8);
}

static inline int bits_for(uint64_t max_val) {
  int b = 1;
  while ((1ull << b) <= max_val && b < 63) ++b;
  return b;
}

struct QtLM : LMBase {
  MappedFile map;  // mmap'd with 8B zero slack for read_bits overreach
  int used_mmap() const override { return map.used_mmap ? 1 : 0; }
  uint64_t vocab_n = 0;                    // word ids are [0, vocab_n]
  const uint64_t* vocab_hashes = nullptr;  // sorted, ids via vocab_ids
  const uint32_t* vocab_ids = nullptr;
  struct Uni { float p, bo; uint32_t child; };
  const Uni* unigram = nullptr;  // vocab_n + 2 entries (incl. sentinel)
  struct Level {
    const uint8_t* bits = nullptr;
    uint64_t count = 0;   // records incl. sentinel (middles) / excl (longest)
    int word_bits = 0, ptr_bits = 0, width = 0;
    const float* prob_cb = nullptr;  // 256
    const float* bo_cb = nullptr;    // 256 (null for longest)
  };
  std::vector<Level> levels;  // orders 2..N (levels[o-2])
  std::string error;

  bool load(const std::string& path) {
    if (!map.open(path, /*slack=*/8)) {  // 8B readable slack for read_bits
      error = "cannot open " + path;
      return false;
    }
    const char* p = map.data();
    const char* end = map.data() + map.size;
    auto need = [&](uint64_t n) {  // bounds-check before every deref
      if ((uint64_t)(end - p) < n) { error = "truncated qt file"; return false; }
      return true;
    };
    if (!need(16) || std::memcmp(p, kQtMagic, 8)) {
      if (error.empty()) error = "bad qt magic";
      return false;
    }
    p += 8;
    uint32_t ord;
    std::memcpy(&ord, p, 4); p += 4;
    p += 4;  // alignment padding (v2): keeps vocab_hashes 8-byte aligned
    order = (int)ord;
    if (order < 1 || order > 16) { error = "bad order"; return false; }
    std::vector<uint64_t> counts(order);
    if (!need(8 * order + 8)) return false;
    std::memcpy(counts.data(), p, 8 * order); p += 8 * order;
    std::memcpy(&vocab_n, p, 8); p += 8;
    if (vocab_n > (uint64_t)(end - p) / 12) { error = "bad qt vocab size"; return false; }
    vocab_hashes = reinterpret_cast<const uint64_t*>(p);
    p += 8 * vocab_n;
    vocab_ids = reinterpret_cast<const uint32_t*>(p);
    p += 4 * vocab_n;
    levels.resize(order >= 2 ? order - 1 : 0);
    for (int o = 2; o <= order; ++o) {
      Level& L = levels[o - 2];
      if (!need(4 * 256 * (o < order ? 2 : 1))) return false;
      L.prob_cb = reinterpret_cast<const float*>(p); p += 4 * 256;
      if (o < order) { L.bo_cb = reinterpret_cast<const float*>(p); p += 4 * 256; }
    }
    if (!need(sizeof(Uni) * (vocab_n + 2))) return false;
    unigram = reinterpret_cast<const Uni*>(p);
    p += sizeof(Uni) * (vocab_n + 2);
    for (int o = 2; o <= order; ++o) {
      Level& L = levels[o - 2];
      uint8_t wb, pb;
      if (!need(10)) return false;
      std::memcpy(&wb, p, 1); p += 1;
      std::memcpy(&pb, p, 1); p += 1;
      std::memcpy(&L.count, p, 8); p += 8;
      L.word_bits = wb;
      L.ptr_bits = pb;
      L.width = L.word_bits + 8 + (o < order ? 8 + L.ptr_bits : 0);
      if (L.width <= 0 || L.width > 128 ||
          L.count > 8 * (uint64_t)(end - p) / (uint64_t)L.width) {
        error = "bad qt level";
        return false;
      }
      L.bits = reinterpret_cast<const uint8_t*>(p);
      p += (L.count * L.width + 7) / 8;
    }
    unk_id = 0;
    bos_id = find_word("<s>");
    eos_id = find_word("</s>");
    return true;
  }

  int find_word(const std::string& w) const override {
    if (w == "<unk>" || w == "<UNK>") return 0;
    uint64_t h = murmur64a(w.data(), w.size());
    const uint64_t* lo = std::lower_bound(vocab_hashes, vocab_hashes + vocab_n, h);
    if (lo == vocab_hashes + vocab_n || *lo != h) return 0;
    return (int)vocab_ids[lo - vocab_hashes];
  }

  // record field accessors (middles have ptr, longest doesn't)
  inline uint64_t rec_word(const Level& L, uint64_t r) const {
    return read_bits(L.bits, r * L.width, L.word_bits);
  }
  inline uint64_t rec_ptr(const Level& L, uint64_t r) const {
    return read_bits(L.bits, r * L.width + L.word_bits + 16, L.ptr_bits);
  }

  bool lookup_pb(const int32_t* ids, int n, float* p, float* b) const override {
    if (n < 1 || n > order) return false;
    uint32_t last = (ids[n - 1] < 0 || (uint64_t)ids[n - 1] > vocab_n)
                        ? 0u : (uint32_t)ids[n - 1];
    if (n == 1) {
      *p = unigram[last].p;
      *b = unigram[last].bo;
      return true;
    }
    uint64_t lo = unigram[last].child, hi = unigram[last + 1].child;
    for (int depth = 2; depth <= n; ++depth) {
      const Level& L = levels[depth - 2];
      uint32_t w = (ids[n - depth] < 0 || (uint64_t)ids[n - depth] > vocab_n)
                       ? 0u : (uint32_t)ids[n - depth];
      // binary search w in records [lo, hi)
      uint64_t a = lo, z = hi;
      while (a < z) {
        uint64_t m = (a + z) >> 1;
        if (rec_word(L, m) < w) a = m + 1; else z = m;
      }
      if (a >= hi || rec_word(L, a) != w) return false;
      if (depth == n) {
        uint64_t off = a * L.width + L.word_bits;
        uint64_t code = read_bits(L.bits, off, 8);
        // Completion-only node: the path exists solely to reach deeper
        // n-grams (pruned-ARPA suffix hole) — no prob stored; back off.
        if (code == kQtPseudoCode) return false;
        *p = L.prob_cb[code];
        *b = (depth < order) ? L.bo_cb[read_bits(L.bits, off + 8, 8)] : 0.f;
        return true;
      }
      lo = rec_ptr(L, a);
      hi = rec_ptr(L, a + 1);
    }
    return false;
  }
};

// ---------------------------------------------------------------------------
// ExternalLM — deferred host-scored LM (ConvLM / any neural LM).
//
// The reference forwards ConvLM on an accelerator per decoder thread
// (cpc/Decode.cpp:489-517 with --lm_vocab mapping and --lm_memory cache).
// TPU-native inversion: the beam decoder collects the pending
// (lm-state, word) score requests of a step, the host scores them in ONE
// batched JAX call, and the scores are applied before pruning — the same
// control inversion S2SDecoder already uses for the AM callback. This type
// only carries the state-truncation length (order-1 = context window) and
// special ids; lookup_pb is never consulted (deferred decoders route all
// scoring through the request queue).
// ---------------------------------------------------------------------------
struct ExternalLM : LMBase {
  ExternalLM(int context, int bos, int eos, int unk) {
    order = context + 1;
    bos_id = bos;
    eos_id = eos;
    unk_id = unk;
  }
  bool lookup_pb(const int32_t*, int, float*, float*) const override {
    return false;
  }
  int find_word(const std::string&) const override { return unk_id; }
};

// Equal-population codebook (kenlm SeparatelyQuantize's binning). Prob
// codebooks use 255 centers (code 255 = kQtPseudoCode reserved); backoff
// codebooks use the full 256.
static std::vector<float> make_codebook(std::vector<float> vals, int centers = 256) {
  std::vector<float> cb;
  if (vals.empty()) { cb.assign(centers, 0.f); return cb; }
  std::sort(vals.begin(), vals.end());
  vals.erase(std::unique(vals.begin(), vals.end()), vals.end());
  if ((int)vals.size() <= centers) {
    cb = vals;
    cb.resize(centers, vals.back());
    return cb;
  }
  cb.reserve(centers);
  for (int i = 0; i < centers; ++i) {
    size_t a = vals.size() * i / centers, z = vals.size() * (i + 1) / centers;
    double s = 0;
    for (size_t j = a; j < z; ++j) s += vals[j];
    cb.push_back((float)(s / std::max<size_t>(1, z - a)));
  }
  std::sort(cb.begin(), cb.end());
  return cb;
}

static uint8_t encode_q(const std::vector<float>& cb, float v) {
  auto it = std::lower_bound(cb.begin(), cb.end(), v);
  if (it == cb.end()) return 255;
  size_t i = it - cb.begin();
  if (i > 0 && std::fabs(cb[i - 1] - v) <= std::fabs(cb[i] - v)) --i;
  return (uint8_t)i;
}

static bool qt_build_binary(const std::string& arpa, const std::string& out,
                            std::string* err) {
  ArpaGrams ag;
  if (!parse_arpa_grams(arpa, &ag, err)) return false;
  int order = ag.order;
  uint64_t vocab_n = ag.words_by_id.size() - 1;  // ids 1..vocab_n (<unk>=0)

  // suffix-trie node key: REVERSED ids (newest word first); real = the
  // n-gram appears in the ARPA (pseudo completion nodes stay false)
  struct Node { std::vector<int32_t> rev; float p = -99.f, bo = 0.f; bool real = false; };
  std::vector<std::vector<Node>> lev(order);  // lev[o-1]: order-o nodes
  struct VecHash {
    size_t operator()(const std::vector<int32_t>& v) const {
      return murmur64a(v.data(), v.size() * 4);
    }
  };
  std::vector<std::unordered_map<std::vector<int32_t>, size_t, VecHash>> idx(order);
  for (int o = 1; o <= order; ++o) {
    for (const auto& g : ag.grams[o - 1]) {
      Node nd;
      nd.rev.assign(g.ids.rbegin(), g.ids.rend());
      nd.p = g.p;
      nd.bo = g.bo;
      nd.real = true;
      auto ins = idx[o - 1].emplace(nd.rev, lev[o - 1].size());
      if (ins.second) lev[o - 1].push_back(std::move(nd));
      else {
        Node& ex = lev[o - 1][ins.first->second];
        ex.p = g.p;
        ex.bo = g.bo;
        ex.real = true;
      }
    }
  }
  // every node's parent path (its rev prefix) must exist: insert pseudo
  // nodes (p=-99, bo=0) for missing suffixes, kenlm/SRILM-style
  for (int o = order; o >= 2; --o) {
    for (const auto& nd : lev[o - 1]) {
      std::vector<int32_t> pfx(nd.rev.begin(), nd.rev.end() - 1);
      for (int po = o - 1; po >= 1; --po) {
        auto ins = idx[po - 1].emplace(pfx, lev[po - 1].size());
        if (!ins.second) break;
        Node pn; pn.rev = pfx;
        lev[po - 1].push_back(std::move(pn));
        pfx.pop_back();
      }
    }
  }
  // sort each level lexicographically by reversed ids: children of one
  // parent are contiguous and parents appear in the same relative order
  std::vector<std::vector<size_t>> perm(order);
  for (int o = 1; o <= order; ++o) {
    perm[o - 1].resize(lev[o - 1].size());
    for (size_t i = 0; i < perm[o - 1].size(); ++i) perm[o - 1][i] = i;
    std::sort(perm[o - 1].begin(), perm[o - 1].end(), [&](size_t a, size_t b) {
      return lev[o - 1][a].rev < lev[o - 1][b].rev;
    });
  }
  // sorted position of each node (for child pointers)
  std::vector<std::unordered_map<std::vector<int32_t>, uint64_t, VecHash>> pos(order);
  for (int o = 1; o <= order; ++o)
    for (size_t r = 0; r < perm[o - 1].size(); ++r)
      pos[o - 1].emplace(lev[o - 1][perm[o - 1][r]].rev, r);

  // child_begin for level o records: first child index in level o+1
  auto child_begins = [&](int o) {  // o = parent order
    uint64_t n_parent = perm[o - 1].size();
    std::vector<uint64_t> cb(n_parent + 1, 0);
    if (o >= order) { return cb; }
    const auto& kids = perm[o];
    // children sorted by rev => parent rev prefix groups are contiguous
    uint64_t k = 0;
    for (uint64_t r = 0; r < n_parent; ++r) {
      const auto& prev = lev[o - 1][perm[o - 1][r]].rev;
      cb[r] = k;
      while (k < kids.size()) {
        const auto& kr = lev[o][kids[k]].rev;
        if (std::equal(prev.begin(), prev.end(), kr.begin())) ++k;
        else break;
      }
    }
    cb[n_parent] = kids.size();
    // cb[r] currently = first child of r; ranges are [cb[r], cb[r+1]) only
    // if every child belongs to some parent in order — guaranteed by the
    // pseudo-node completion above
    return cb;
  };

  // quantization codebooks per order >= 2, from REAL nodes only (pseudo
  // placeholders would pollute the equal-population bins); prob codebooks
  // reserve code 255 for pseudo nodes, bo codebooks force a 0.0 center so
  // pseudo contexts contribute exactly zero backoff
  std::vector<std::vector<float>> prob_cbs(order + 1), bo_cbs(order + 1);
  for (int o = 2; o <= order; ++o) {
    std::vector<float> ps, bs;
    for (const auto& nd : lev[o - 1])
      if (nd.real) { ps.push_back(nd.p); bs.push_back(nd.bo); }
    prob_cbs[o] = make_codebook(std::move(ps), 255);
    // slot 255: +inf sentinel — encode_q's nearest-center step-down can
    // never pick it, so only pseudo nodes carry code 255
    prob_cbs[o].push_back(std::numeric_limits<float>::infinity());
    if (o < order) {
      bs.push_back(0.f);
      bo_cbs[o] = make_codebook(std::move(bs));
    }
  }

  // serialize
  std::vector<uint64_t> counts(order);
  for (int o = 1; o <= order; ++o) counts[o - 1] = lev[o - 1].size();
  std::ofstream of(out, std::ios::binary);
  if (!of) { *err = "cannot write " + out; return false; }
  of.write(kQtMagic, 8);
  uint32_t ord32 = (uint32_t)order;
  of.write(reinterpret_cast<const char*>(&ord32), 4);
  uint32_t pad32 = 0;  // aligns the vocab hash array to 8 bytes (v2)
  of.write(reinterpret_cast<const char*>(&pad32), 4);
  of.write(reinterpret_cast<const char*>(counts.data()), 8 * order);
  of.write(reinterpret_cast<const char*>(&vocab_n), 8);
  {  // vocab: sorted hashes + parallel ids
    std::vector<std::pair<uint64_t, uint32_t>> vh;
    for (uint32_t id = 1; id <= (uint32_t)vocab_n; ++id) {
      const std::string& w = ag.words_by_id[id];
      vh.push_back({murmur64a(w.data(), w.size()), id});
    }
    std::sort(vh.begin(), vh.end());
    std::vector<uint64_t> hs(vh.size());
    std::vector<uint32_t> is(vh.size());
    for (size_t i = 0; i < vh.size(); ++i) { hs[i] = vh[i].first; is[i] = vh[i].second; }
    of.write(reinterpret_cast<const char*>(hs.data()), 8 * hs.size());
    of.write(reinterpret_cast<const char*>(is.data()), 4 * is.size());
  }
  for (int o = 2; o <= order; ++o) {
    of.write(reinterpret_cast<const char*>(prob_cbs[o].data()), 4 * 256);
    if (o < order)
      of.write(reinterpret_cast<const char*>(bo_cbs[o].data()), 4 * 256);
  }
  {  // unigram: dense by id 0..vocab_n + sentinel, full precision
    auto cb1 = child_begins(1);
    std::vector<QtLM::Uni> uni(vocab_n + 2);
    for (auto& u : uni) { u.p = -10.f; u.bo = 0.f; u.child = 0; }
    // child pointers come from sorted level-1 order; level 1 rev = {id}
    for (uint64_t r = 0; r < perm[0].size(); ++r) {
      const Node& nd = lev[0][perm[0][r]];
      uint32_t id = (uint32_t)nd.rev[0];
      // pseudo unigrams (word only reachable via higher grams — ill-formed
      // ARPA) keep the absent-word default rather than the -99 placeholder
      uni[id].p = nd.real ? nd.p : -10.f;
      uni[id].bo = nd.real ? nd.bo : 0.f;
    }
    // dense child ranges: walk ids in sorted-node order (rev = {id} sorts
    // numerically, so sorted order == id order for present ids)
    uint64_t next_child = 0;
    uint64_t r = 0;
    for (uint64_t id = 0; id <= vocab_n; ++id) {
      uni[id].child = (uint32_t)next_child;
      if (r < perm[0].size() && (uint64_t)lev[0][perm[0][r]].rev[0] == id) {
        uni[id].child = (uint32_t)cb1[r];
        next_child = cb1[r + 1];
        ++r;
      }
    }
    uni[vocab_n + 1].child = (uint32_t)(order >= 2 ? perm[1].size() : 0);
    of.write(reinterpret_cast<const char*>(uni.data()), sizeof(QtLM::Uni) * uni.size());
  }
  for (int o = 2; o <= order; ++o) {
    bool mid = o < order;
    uint64_t n = perm[o - 1].size();
    uint64_t next_n = mid ? perm[o].size() : 0;
    uint8_t word_bits = (uint8_t)bits_for(vocab_n);
    uint8_t ptr_bits = mid ? (uint8_t)bits_for(next_n) : 0;
    int width = word_bits + 8 + (mid ? 8 + ptr_bits : 0);
    uint64_t n_rec = n + (mid ? 1 : 0);  // +sentinel for ranges
    std::vector<uint8_t> bits((n_rec * width + 7) / 8 + 8, 0);
    auto cbs = mid ? child_begins(o) : std::vector<uint64_t>();
    for (uint64_t r = 0; r < n; ++r) {
      const Node& nd = lev[o - 1][perm[o - 1][r]];
      uint64_t off = r * width;
      write_bits(bits, off, (uint64_t)nd.rev.back(), word_bits);
      uint8_t pcode = nd.real ? encode_q(prob_cbs[o], nd.p) : kQtPseudoCode;
      write_bits(bits, off + word_bits, pcode, 8);
      if (mid) {
        write_bits(bits, off + word_bits + 8, encode_q(bo_cbs[o], nd.bo), 8);
        write_bits(bits, off + word_bits + 16, cbs[r], ptr_bits);
      }
    }
    if (mid) {  // sentinel: end-of-children for the last record
      uint64_t off = n * width;
      write_bits(bits, off + word_bits + 16, cbs[n], ptr_bits);
    }
    of.write(reinterpret_cast<const char*>(&word_bits), 1);
    of.write(reinterpret_cast<const char*>(&ptr_bits), 1);
    of.write(reinterpret_cast<const char*>(&n_rec), 8);
    of.write(reinterpret_cast<const char*>(bits.data()), (n_rec * width + 7) / 8);
  }
  return (bool)of;
}

static bool is_qt_binary(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  char head[8] = {0};
  f.read(head, 8);
  return f && !std::memcmp(head, kQtMagic, 8);
}

// Sniff: kenlm binary magic vs ARPA text.
static bool is_kenlm_binary(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  char head[sizeof(kKenlmMagicPrefix)] = {0};
  f.read(head, sizeof(kKenlmMagicPrefix) - 1);
  return f && !std::memcmp(head, kKenlmMagicPrefix, sizeof(kKenlmMagicPrefix) - 1);
}

// LM state = up to (order-1) word ids, interned so states can be compared
// by id (hyp merging).
struct LMStatePool {
  std::unordered_map<std::string, int> ids;
  std::vector<std::vector<int32_t>> states;
  int intern(const int32_t* w, int n) {
    std::string k(reinterpret_cast<const char*>(w), n * sizeof(int32_t));
    auto it = ids.find(k);
    if (it != ids.end()) return it->second;
    int id = (int)states.size();
    ids.emplace(std::move(k), id);
    states.emplace_back(w, w + n);
    return id;
  }
};

// ---------------------------------------------------------------------------
// Lexicon trie (flattened) with smearing
// ---------------------------------------------------------------------------
struct TrieNode {
  std::unordered_map<int, int> children;  // token -> node index
  std::vector<int> labels;                // word ids
  std::vector<float> scores;
  float max_score = 0.f;
};

struct Trie {
  std::vector<TrieNode> nodes;  // node 0 = root
  Trie() { nodes.emplace_back(); }

  int insert(const int32_t* toks, int n, int word, float score) {
    int cur = 0;
    for (int i = 0; i < n; i++) {
      auto& ch = nodes[cur].children;
      auto it = ch.find(toks[i]);
      if (it == ch.end()) {
        int idx = (int)nodes.size();
        ch.emplace(toks[i], idx);
        nodes.emplace_back();
        cur = idx;
      } else {
        cur = it->second;
      }
    }
    nodes[cur].labels.push_back(word);
    nodes[cur].scores.push_back(score);
    return cur;
  }

  // smear: 0 none, 1 max, 2 logadd (iterative post-order)
  void smear(int mode) {
    if (mode == 0) return;
    std::vector<std::pair<int, bool>> stack{{0, false}};
    while (!stack.empty()) {
      auto [ni, done] = stack.back();
      stack.pop_back();
      if (!done) {
        stack.push_back({ni, true});
        for (auto& kv : nodes[ni].children) stack.push_back({kv.second, false});
        continue;
      }
      auto& nd = nodes[ni];
      double acc = kNegInf;
      bool any = false;
      for (float s : nd.scores) {
        acc = (mode == 1) ? std::max(acc, (double)s) : (any ? logadd(acc, s) : s);
        any = true;
      }
      for (auto& kv : nodes[ni].children) {
        double cs = nodes[kv.second].max_score;
        acc = (mode == 1) ? std::max(acc, cs) : (any ? logadd(acc, cs) : cs);
        any = true;
      }
      nd.max_score = any ? (float)acc : (float)kNegInf;
    }
  }
};

// ---------------------------------------------------------------------------
// beam decoder
// ---------------------------------------------------------------------------
struct DecoderOptions {
  int beam_size = 2500;
  int beam_size_token = 250000;
  double beam_threshold = 25.0;
  double lm_weight = 0.0;
  double word_score = 0.0;
  double unk_score = kNegInf;
  double sil_score = 0.0;
  int log_add = 0;
  int criterion = 0;  // 0 CTC, 1 ASG
};

struct Hyp {
  double score;
  double am_score;
  double lm_score;
  int lm_state;
  int node;  // trie node (-1 lexicon-free)
  int parent;  // index into prev frame's hyp arena
  int token;
  int word;  // emitted word this step (-1)
  bool prev_blank;
};

struct Decoder {
  DecoderOptions opts;
  Trie* trie = nullptr;           // may be null (lexicon-free)
  LMBase* lm = nullptr;           // may be null (zero LM)
  LMStatePool pool;
  int sil = 0, blank = -1, unk_word = -1;
  std::vector<float> transitions;  // N*N or empty
  int n_tokens = 0;
  bool is_token_lm = false;
  std::vector<int32_t> usr_to_lm;  // word idx (or token idx) -> LM word id

  // lattice: per-frame hypothesis arrays
  std::vector<std::vector<Hyp>> frames;

  double trans(int to, int from) const {
    if (transitions.empty() || from < 0) return 0.0;
    return transitions[to * n_tokens + from];
  }

  int lm_start_state() {
    if (!lm || lm->bos_id < 0) return pool.intern(nullptr, 0);
    int32_t b = lm->bos_id;
    return pool.intern(&b, 1);
  }

  std::pair<int, float> lm_score(int state, int32_t usr_idx) {
    if (!lm) return {state, 0.f};
    int32_t w = (usr_idx >= 0 && usr_idx < (int)usr_to_lm.size())
                    ? usr_to_lm[usr_idx]
                    : usr_idx;
    auto& h = pool.states[state];
    float s = lm->score(h.data(), (int)h.size(), w);
    // next state: (h + w) truncated to order-1
    std::vector<int32_t> nh(h);
    nh.push_back(w);
    int keep = std::max(0, lm->order - 1);
    if ((int)nh.size() > keep) nh.erase(nh.begin(), nh.end() - keep);
    return {pool.intern(nh.data(), (int)nh.size()), s};
  }

  float lm_finish(int state) {
    if (!lm || lm->eos_id < 0) return 0.f;
    auto& h = pool.states[state];
    return lm->score(h.data(), (int)h.size(), lm->eos_id);
  }

  // transitions are gated off on the very first decoded frame (reference
  // `nDecodedFrames_ + t > 0` guard: the initial sil token is synthetic)
  bool first_step = true;

  void begin() {
    frames.clear();
    frames.emplace_back();
    first_step = true;
    ended = false;
    Hyp h{0.0, 0.0, 0.0, lm_start_state(), trie ? 0 : -1, -1, sil, -1, false};
    frames.back().push_back(h);
  }

  // candidate merging: key = (lm_state, node, token, prev_blank) — the
  // reference LexiconDecoderState::compareNoScoreStates fields
  struct KeyHash {
    size_t operator()(const std::tuple<int, int, int, bool>& k) const {
      auto [a, b, t, c] = k;
      return std::hash<int64_t>()(
          (((int64_t)a * 1000003) ^ ((int64_t)b << 20) ^ ((int64_t)t << 1)) ^ c);
    }
  };

  void add_cand(
      std::unordered_map<std::tuple<int, int, int, bool>, int, KeyHash>& keys,
      std::vector<Hyp>& cands, const Hyp& h, double& best) {
    best = std::max(best, h.score);
    auto k = std::make_tuple(h.lm_state, h.node, h.token, h.prev_blank);
    auto it = keys.find(k);
    if (it == keys.end()) {
      keys.emplace(k, (int)cands.size());
      cands.push_back(h);
      return;
    }
    Hyp& old = cands[it->second];
    if (opts.log_add) {
      double m = logadd(old.score, h.score);
      if (h.score > old.score) { Hyp t = h; t.score = m; old = t; }
      else old.score = m;
      best = std::max(best, m);
    } else if (h.score > old.score) {
      old = h;
    }
  }

  // -- deferred-LM plumbing (ExternalLM / ConvLM) --------------------------
  // Candidate generation and pruning are split into collect/apply phases.
  // With a sync n-gram LM, collect scores inline and apply(nullptr) merges
  // and prunes. With an ExternalLM, collect enqueues deduped
  // (lm_state, lm_word) requests; the host scores them in one batched
  // device call and apply(scores) resolves each pending candidate as
  //   score = score_so_far + lm_weight * (s + corr),  lm_score = lm_base + s
  // (corr = -child.max_score for lexicon word emissions, undoing the trie
  // smear contribution the in-word walk added; 0 otherwise).
  bool deferred = false;
  struct PendCand { Hyp h; int req; float corr; double lm_base; };
  std::vector<PendCand> pend;
  std::vector<std::pair<int, int32_t>> reqs;  // (lm_state, lm word id)
  std::unordered_map<int64_t, int> req_idx;

  int32_t map_usr(int32_t usr_idx) const {
    return (usr_idx >= 0 && usr_idx < (int)usr_to_lm.size())
               ? usr_to_lm[usr_idx]
               : usr_idx;
  }

  int req_intern(int state, int32_t w_lm) {
    int64_t k = ((int64_t)state << 32) | (uint32_t)w_lm;
    auto it = req_idx.find(k);
    if (it != req_idx.end()) return it->second;
    int id = (int)reqs.size();
    reqs.push_back({state, w_lm});
    req_idx.emplace(k, id);
    return id;
  }

  // next LM state after consuming lm word id (no score needed)
  int lm_next_state(int state, int32_t w_lm) {
    auto& h = pool.states[state];
    std::vector<int32_t> nh(h);
    nh.push_back(w_lm);
    int keep = std::max(0, lm->order - 1);
    if ((int)nh.size() > keep) nh.erase(nh.begin(), nh.end() - keep);
    return pool.intern(nh.data(), (int)nh.size());
  }

  int step_collect(const float* em) {
    pend.clear();
    reqs.clear();
    req_idx.clear();
    const auto& prev = frames.back();
    pend.reserve(prev.size() * 8);
    const bool ctc = opts.criterion == 0;

    // top-k tokens
    std::vector<int> top(n_tokens);
    for (int i = 0; i < n_tokens; i++) top[i] = i;
    int k = std::min(opts.beam_size_token, n_tokens);
    if (k < n_tokens) {
      std::partial_sort(top.begin(), top.begin() + k, top.end(),
                        [&](int a, int b) { return em[a] > em[b]; });
      top.resize(k);
    }

    // beam_size_token membership mask — restricts NEW token emissions only
    // (the same-node / blank paths bypass it, as in the reference)
    std::vector<char> allow;
    if (k < n_tokens) {
      allow.assign(n_tokens, 0);
      for (int t : top) allow[t] = 1;
    }

    for (int pi = 0; pi < (int)prev.size(); pi++) {
      const Hyp& hyp = prev[pi];
      if (trie) {
        // Reference LexiconDecoder::decodeStep. Lexicon spellings are
        // '|'-terminated, so word labels live on sil-children and word
        // emission happens BY traversing that child — sil is never a
        // bare "reset to root" in lexicon mode.
        const auto& nd = trie->nodes[hyp.node];
        const bool at_root = hyp.node == 0;
        // smear baseline: 0 at root (reference lexMaxScore)
        const double lex_max = at_root ? 0.0 : (double)nd.max_score;

        /* (1) trie children: new token emissions */
        for (const auto& kv : nd.children) {
          const int tok = kv.first;
          if (!allow.empty() && !allow[tok]) continue;
          const int ci = kv.second;
          const auto& child = trie->nodes[ci];
          const double am = em[tok];
          double sc = hyp.score + am;
          if (!first_step) sc += trans(tok, hyp.token);
          if (tok == sil) sc += opts.sil_score;
          // token-level LM scores the token itself once (isLmToken_)
          int tl_state = hyp.lm_state;
          double tl_s = 0.0;
          int tl_req = -1;
          if (is_token_lm && opts.lm_weight != 0.0) {
            int32_t wlm = map_usr(tok);
            if (deferred) {
              tl_req = req_intern(hyp.lm_state, wlm);
              tl_state = lm_next_state(hyp.lm_state, wlm);
            } else {
              auto [st2, s] = lm_score(hyp.lm_state, tok);
              tl_state = st2;
              tl_s = s;
            }
          }
          // eat-up a new token (CTC: same token without a blank between is
          // the same emission — handled by (2), no trie advance)
          if ((!ctc || hyp.prev_blank || tok != hyp.token) &&
              !child.children.empty()) {
            Hyp nh{sc, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                   ci, pi, tok, -1, false};
            if (is_token_lm && opts.lm_weight != 0.0) {
              nh.lm_state = tl_state;
              nh.score += opts.lm_weight * tl_s;
              nh.lm_score += tl_s;
              pend.push_back({nh, tl_req, 0.f, hyp.lm_score});
            } else {
              if (opts.lm_weight != 0.0) {
                double delta = (double)child.max_score - lex_max;
                nh.score += opts.lm_weight * delta;
                nh.lm_score += delta;
              }
              pend.push_back({nh, -1, 0.f, nh.lm_score});
            }
          }
          // true-word emissions at labeled children: back to root, replace
          // the accumulated smear (lex_max) with the real LM word score
          for (size_t wi = 0; wi < child.labels.size(); wi++) {
            const int w = child.labels[wi];
            // single-token-spelling guard (reference): a word whose whole
            // spelling is one token must not re-emit on consecutive frames
            if (at_root && hyp.token == tok) continue;
            const double bonus =
                (w == unk_word) ? opts.unk_score : opts.word_score;
            if (bonus == kNegInf) continue;
            Hyp nh{sc + bonus, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                   0, pi, tok, w, false};
            if (opts.lm_weight != 0.0 && !is_token_lm) {
              // lm_score telescopes clean: the in-word smear deltas in
              // hyp.lm_score sum to lex_max; replace with the true score
              int32_t wlm_id = map_usr(w);
              if (deferred) {
                int wreq = req_intern(hyp.lm_state, wlm_id);
                nh.lm_state = lm_next_state(hyp.lm_state, wlm_id);
                pend.push_back(
                    {nh, wreq, (float)(-lex_max), hyp.lm_score - lex_max});
                continue;
              }
              auto [st2, s] = lm_score(hyp.lm_state, w);
              nh.lm_state = st2;
              nh.score += opts.lm_weight * ((double)s - lex_max);
              nh.lm_score = hyp.lm_score + s - lex_max;
            } else if (opts.lm_weight != 0.0 && is_token_lm) {
              nh.lm_state = tl_state;
              nh.score += opts.lm_weight * tl_s;
              nh.lm_score += tl_s;
              pend.push_back({nh, tl_req, 0.f, hyp.lm_score});
              continue;
            }
            pend.push_back({nh, -1, 0.f, nh.lm_score});
          }
          // unknown-word emission at label-less nodes (reference: OOV
          // prefixes may surface as <unk> when unkScore is finite)
          if (child.labels.empty() && opts.unk_score > kNegInf &&
              unk_word >= 0 && !is_token_lm) {
            Hyp nh{sc + opts.unk_score, hyp.am_score + am, hyp.lm_score,
                   hyp.lm_state, 0, pi, tok, unk_word, false};
            if (opts.lm_weight != 0.0) {
              int32_t wlm_id = map_usr(unk_word);
              if (deferred) {
                int wreq = req_intern(hyp.lm_state, wlm_id);
                nh.lm_state = lm_next_state(hyp.lm_state, wlm_id);
                pend.push_back(
                    {nh, wreq, (float)(-lex_max), hyp.lm_score - lex_max});
                continue;
              }
              auto [st2, s] = lm_score(hyp.lm_state, unk_word);
              nh.lm_state = st2;
              nh.score += opts.lm_weight * ((double)s - lex_max);
              nh.lm_score = hyp.lm_score + s - lex_max;
            }
            pend.push_back({nh, -1, 0.f, nh.lm_score});
          }
        }

        /* (2) same lexicon node: sil at root, else repeat of the last
           token (CTC merge / ASG repeat) */
        if (!ctc || !hyp.prev_blank || at_root) {
          const int tok2 = at_root ? sil : hyp.token;
          if (tok2 >= 0 && tok2 != blank) {
            const double am = em[tok2];
            double sc = hyp.score + am;
            if (!first_step) sc += trans(tok2, hyp.token);
            if (tok2 == sil) sc += opts.sil_score;
            Hyp nh{sc, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                   hyp.node, pi, tok2, -1, false};
            pend.push_back({nh, -1, 0.f, nh.lm_score});
          }
        }

        /* (3) CTC blank: stay, mark prev_blank */
        if (ctc && blank >= 0) {
          const double am = em[blank];
          Hyp nh{hyp.score + am, hyp.am_score + am, hyp.lm_score,
                 hyp.lm_state, hyp.node, pi, blank, -1, true};
          pend.push_back({nh, -1, 0.f, nh.lm_score});
        }
      } else {
        // lexicon-free: token-level LM (reference LexiconFreeDecoder)
        for (int tok : top) {
          double am = em[tok];
          double base = hyp.score + am;
          if (ctc && tok == blank) {
            Hyp nh{base, hyp.am_score + am, hyp.lm_score, hyp.lm_state,
                   hyp.node, pi, tok, -1, true};
            pend.push_back({nh, -1, 0.f, nh.lm_score});
            continue;
          }
          if (tok == hyp.token && (!ctc || !hyp.prev_blank)) {
            // same emission: no LM, no trie advance
            double sc = base;
            if (!first_step) sc += trans(tok, hyp.token);
            if (tok == sil) sc += opts.sil_score;
            Hyp nh{sc, hyp.am_score + am, hyp.lm_score,
                   hyp.lm_state, hyp.node, pi, tok, -1, false};
            pend.push_back({nh, -1, 0.f, nh.lm_score});
            continue;
          }
          double sc = base;
          if (!first_step) sc += trans(tok, hyp.token);
          double lm_sc = hyp.lm_score;
          int lst = hyp.lm_state;
          int req = -1;
          if (opts.lm_weight != 0.0 && lm) {
            int32_t wlm = map_usr(tok);
            if (deferred) {
              req = req_intern(lst, wlm);
              lst = lm_next_state(lst, wlm);
            } else {
              auto [st2, s] = lm_score(lst, tok);
              lst = st2;
              sc += opts.lm_weight * s;
              lm_sc += s;
            }
          }
          if (tok == sil) sc += opts.sil_score;
          Hyp nh{sc, hyp.am_score + am, lm_sc, lst, tok /* node slot stores
                 last token for merge key in lexicon-free mode */,
                 pi, tok, -1, false};
          pend.push_back({nh, req, 0.f, lm_sc});
        }
      }
    }
    return (int)reqs.size();
  }

  void step_apply(const float* scores) {
    if (deferred && !scores && !reqs.empty()) {
      // caller used the sync API with an ExternalLM: LM scores would be
      // silently dropped — surface it loudly
      std::fprintf(stderr,
                   "w2l_decoder: %zu pending LM requests but no scores "
                   "(use the collect/apply API with a deferred LM)\n",
                   reqs.size());
    }
    std::unordered_map<std::tuple<int, int, int, bool>, int, KeyHash> keys;
    std::vector<Hyp> cands;
    cands.reserve(pend.size());
    double best = kNegInf;
    for (auto& pc : pend) {
      Hyp h = pc.h;
      if (pc.req >= 0 && scores) {
        double s = scores[pc.req];
        h.score += opts.lm_weight * (s + pc.corr);
        h.lm_score = pc.lm_base + s;
      }
      add_cand(keys, cands, h, best);
    }
    pend.clear();
    // threshold + top beam_size
    double thr = best - opts.beam_threshold;
    std::vector<Hyp> kept;
    kept.reserve(cands.size());
    for (auto& h : cands)
      if (h.score >= thr) kept.push_back(h);
    if ((int)kept.size() > opts.beam_size) {
      std::partial_sort(kept.begin(), kept.begin() + opts.beam_size, kept.end(),
                        [](const Hyp& a, const Hyp& b) { return a.score > b.score; });
      kept.resize(opts.beam_size);
    } else {
      std::sort(kept.begin(), kept.end(),
                [](const Hyp& a, const Hyp& b) { return a.score > b.score; });
    }
    frames.push_back(std::move(kept));
    first_step = false;
  }

  void step_frame(const float* em) {
    step_collect(em);
    step_apply(nullptr);
  }

  std::vector<Hyp> end_pend;
  std::vector<int> end_reqs;

  int end_collect() {
    reqs.clear();
    req_idx.clear();
    end_pend = frames.back();  // copy
    // reference "hasNiceEnding": if any hyp finishes at the trie root
    // (complete word), mid-word finals are dropped
    if (trie) {
      bool nice = false;
      for (const auto& h : end_pend)
        if (h.node == 0) { nice = true; break; }
      if (nice) {
        std::vector<Hyp> kept;
        kept.reserve(end_pend.size());
        for (const auto& h : end_pend)
          if (h.node == 0) kept.push_back(h);
        end_pend = std::move(kept);
      }
    }
    end_reqs.assign(end_pend.size(), -1);
    if (lm && opts.lm_weight != 0.0 && lm->eos_id >= 0 && deferred) {
      for (size_t i = 0; i < end_pend.size(); i++)
        end_reqs[i] = req_intern(end_pend[i].lm_state, lm->eos_id);
    }
    return (int)reqs.size();
  }

  void end_apply(const float* scores) {
    auto fin = std::move(end_pend);
    for (size_t i = 0; i < fin.size(); i++) {
      Hyp& h = fin[i];
      if (opts.lm_weight != 0.0 && lm) {
        float s = (deferred && scores && end_reqs[i] >= 0)
                      ? scores[end_reqs[i]]
                      : (deferred ? 0.f : lm_finish(h.lm_state));
        h.score += opts.lm_weight * s;
        h.lm_score += s;
      }
    }
    end_finish(std::move(fin));
  }

  void end() {
    end_collect();
    end_apply(nullptr);
  }

  // true once end() pushed the final marker frame (whose hyps duplicate the
  // last real frame); backtrack must skip it, but must NOT skip the newest
  // real frame when called mid-stream (online getBestHypothesis before
  // prune — reference AudioToWords.cpp:64-105 consumes words per chunk)
  bool ended = false;

  void end_finish(std::vector<Hyp> fin) {
    ended = true;
    std::sort(fin.begin(), fin.end(),
              [](const Hyp& a, const Hyp& b) { return a.score > b.score; });
    // store as a final frame whose parents reference the last step frame
    // directly (parent indices are hypothesis indices in frames[T-1]... but
    // we copied — fix parents to point at themselves in the previous frame)
    for (size_t i = 0; i < fin.size(); i++) {
      // find original index: parent chain stays valid because we copied the
      // hyps including their parent fields; but THIS frame's hyps' parents
      // must reference the frame before the final frame. They currently
      // reference frames[T-2] (set during step). Since we copied from
      // frames.back() (frame T-1), their own position changed but parent
      // fields still point correctly into frame T-2 only for backtracking
      // FROM frame T-1. To keep backtrack simple we instead record the
      // mapping: final hyp i corresponds to original hyp with same parent/
      // token/word — we push a frame where each hyp's parent is its original
      // index in frame T-1.
    }
    // simpler: recompute — find for each fin hyp its source index by pointer
    // comparison is lost after copy; instead we re-run: attach parent = index
    // of identical hyp in frames.back(). Identity: compare all fields except
    // score/lm adjustments. We stored original order before sort? Use a map
    // from (parent,token,word,lm_state,node,prev_blank) -> index.
    std::unordered_map<std::string, int> srcmap;
    const auto& last = frames.back();
    for (int i = 0; i < (int)last.size(); i++) {
      const Hyp& h = last[i];
      std::ostringstream k;
      k << h.parent << ':' << h.token << ':' << h.word << ':' << h.lm_state
        << ':' << h.node << ':' << h.prev_blank;
      srcmap.emplace(k.str(), i);
    }
    for (auto& h : fin) {
      std::ostringstream k;
      k << h.parent << ':' << h.token << ':' << h.word << ':' << h.lm_state
        << ':' << h.node << ':' << h.prev_blank;
      auto it = srcmap.find(k.str());
      h.parent = it == srcmap.end() ? -1 : it->second;
    }
    frames.push_back(std::move(fin));
  }

  // backtrack hypothesis hi at the newest frame into tokens/words
  void backtrack(int hi, std::vector<int>& tokens, std::vector<int>& words) const {
    tokens.clear();
    words.clear();
    int T = (int)frames.size() - 1;  // newest frame index
    if (T < 1) return;
    int fi, t0;
    if (ended) {
      // final marker frame: its hyp's parent = index in frame T-1 of the
      // same (real) hyp; the marker's own token is synthetic
      fi = frames[T][hi].parent;
      t0 = T - 1;
      if (fi < 0) return;
    } else {
      fi = hi;
      t0 = T;
    }
    for (int t = t0; t >= 1; t--) {
      const Hyp& cur = frames[t][fi];
      tokens.push_back(cur.token);
      words.push_back(cur.word);
      fi = cur.parent;
      if (fi < 0) break;
    }
    std::reverse(tokens.begin(), tokens.end());
    std::reverse(words.begin(), words.end());
  }
};

// ---------------------------------------------------------------------------
// Seq2Seq beam decoder (reference LexiconSeq2SeqDecoder /
// LexiconFreeSeq2SeqDecoder, cpc/Decode.cpp:529-624). The attention-decoder
// AM step runs as ONE batched jitted device call per output position, driven
// from Python: each w2l_s2s_step consumes the (K, V) log-prob matrix for the
// current beam and returns the next beam's last tokens + the state rows to
// gather — control-inverted amUpdateFunc. All candidate generation, trie
// constraint, n-gram LM scoring, and pruning (eosScore, attentionThreshold,
// hard/soft selection, beamThreshold) happen here in C++. Semantics match
// wav2letter_tpu/decoder/seq2seq_beam.py (differentially tested).
// ---------------------------------------------------------------------------
struct S2SOptions {
  int beam_size = 10;
  int beam_size_token = 1 << 30;
  double beam_threshold = 1e30;
  double lm_weight = 0.0;
  double word_score = 0.0;
  double eos_score = 0.0;
  double attention_threshold = kInf;   // max allowed attention-peak jump
  double hard_selection = kInf;        // cap cands at beam_size*hard_selection
  double soft_selection = kInf;        // drop cands > soft below step best
};

struct S2SEntry {  // arena node: one emitted token (and possibly one word)
  int parent;      // arena index of previous entry (-1 = sequence start)
  int32_t token;
  int32_t word;    // word emitted at this step (-1 none)
};

struct S2SHyp {
  double score, am_score, lm_score;
  int lm_state;    // LMStatePool id
  int node;        // trie node (-1 lexicon-free)
  int entry;       // arena index of last emitted token (-1 at start)
  int row;         // which row of the *previous* device call this came from
  int peak;        // attention peak frame recorded at creation
  int32_t last_tok;
  bool completed;
};

struct S2SDecoder {
  S2SOptions opts;
  Trie* trie = nullptr;      // null = lexicon-free
  LMBase* lm = nullptr;      // null = zero LM
  LMStatePool pool;
  std::vector<int32_t> usr_to_lm;  // word idx (lexicon) / token idx (free) -> LM id
  int eos = -1;
  int word_sep = -1;
  std::vector<S2SEntry> arena;
  std::vector<S2SHyp> beam;
  std::vector<S2SHyp> finished;
  bool was_completed = false;
  std::vector<int> top_buf;  // scratch for per-row top-k

  int lm_start() {
    if (!lm || lm->bos_id < 0) return pool.intern(nullptr, 0);
    int32_t b = lm->bos_id;
    return pool.intern(&b, 1);
  }

  std::pair<int, float> lm_extend(int state, int32_t usr_idx) {
    if (!lm || opts.lm_weight == 0.0) return {state, 0.f};
    int32_t w = (usr_idx >= 0 && usr_idx < (int)usr_to_lm.size())
                    ? usr_to_lm[usr_idx]
                    : usr_idx;
    auto& h = pool.states[state];
    float s = lm->score(h.data(), (int)h.size(), w);
    std::vector<int32_t> nh(h);
    nh.push_back(w);
    int keep = std::max(0, lm->order - 1);
    if ((int)nh.size() > keep) nh.erase(nh.begin(), nh.end() - keep);
    return {pool.intern(nh.data(), (int)nh.size()), s};
  }

  void begin() {
    arena.clear();
    beam.clear();
    finished.clear();
    pool = LMStatePool();
    was_completed = false;
    beam.push_back(S2SHyp{0.0, 0.0, 0.0, lm_start(), trie ? 0 : -1, -1, 0, 0,
                          (int32_t)eos, false});
  }

  // -- deferred-LM plumbing (ExternalLM / ConvLM), mirroring Decoder's ----
  bool deferred = false;
  std::vector<std::pair<int, int32_t>> reqs;  // (lm_state, lm word id)
  std::unordered_map<int64_t, int> req_idx;

  int32_t map_usr(int32_t usr_idx) const {
    return (usr_idx >= 0 && usr_idx < (int)usr_to_lm.size())
               ? usr_to_lm[usr_idx]
               : usr_idx;
  }

  int req_intern(int state, int32_t w_lm) {
    int64_t k = ((int64_t)state << 32) | (uint32_t)w_lm;
    auto it = req_idx.find(k);
    if (it != req_idx.end()) return it->second;
    int id = (int)reqs.size();
    reqs.push_back({state, w_lm});
    req_idx.emplace(k, id);
    return id;
  }

  int lm_next_state(int state, int32_t w_lm) {
    auto& h = pool.states[state];
    std::vector<int32_t> nh(h);
    nh.push_back(w_lm);
    int keep = std::max(0, lm->order - 1);
    if ((int)nh.size() > keep) nh.erase(nh.begin(), nh.end() - keep);
    return pool.intern(nh.data(), (int)nh.size());
  }

  struct Cand {
    double score, am_score, lm_score;
    int lm_state, node, src, peak;
    int32_t token, word;
    int req;  // pending LM request (-1 none); resolved in step_apply
  };
  std::vector<Cand> pend;

  // Phase 1: consume the (K, V) log-prob matrix (+ optional per-row
  // attention peaks) for the current beam; generate candidates. With a
  // deferred LM, returns the number of pending (state, word) score
  // requests; step_apply finishes the step either way.
  int step_collect(const float* logp, const int32_t* peaks, int K, int V) {
    pend.clear();
    reqs.clear();
    req_idx.clear();
    int n_tok = std::min(opts.beam_size_token, V);
    for (int bi = 0; bi < (int)beam.size() && bi < K; ++bi) {
      const S2SHyp& hyp = beam[bi];
      int pk = peaks ? (int)peaks[bi] : 0;
      if (peaks && std::isfinite(opts.attention_threshold) &&
          std::abs((double)(pk - hyp.peak)) > opts.attention_threshold)
        continue;  // attention jumped implausibly far: prune all extensions
      const float* row = logp + (size_t)bi * V;
      top_buf.resize(V);
      for (int i = 0; i < V; i++) top_buf[i] = i;
      if (n_tok < V)
        std::nth_element(top_buf.begin(), top_buf.begin() + n_tok,
                         top_buf.end(),
                         [&](int a, int b) { return row[a] > row[b]; });
      for (int ti = 0; ti < n_tok; ++ti) {
        int tok = top_buf[ti];
        double sc = hyp.score + row[tok];
        if (tok == eos) {
          S2SHyp fh = hyp;
          fh.score = sc + opts.eos_score;
          fh.am_score = hyp.am_score + row[tok];
          finished.push_back(fh);
          continue;
        }
        Cand c{sc, hyp.am_score + row[tok], hyp.lm_score, hyp.lm_state,
               hyp.node, bi, pk, (int32_t)tok, -1, -1};
        if (trie) {
          int node = hyp.node < 0 ? 0 : hyp.node;
          if (word_sep >= 0 && tok == word_sep) {
            c.node = 0;  // word separator: back to root, nothing emitted
          } else {
            auto it = trie->nodes[node].children.find(tok);
            if (it == trie->nodes[node].children.end()) continue;  // not a word prefix
            const TrieNode& child = trie->nodes[it->second];
            if (!child.labels.empty()) {
              int w = child.labels[0];
              c.word = w;
              if (deferred && lm && opts.lm_weight != 0.0) {
                int32_t wlm = map_usr(w);
                c.req = req_intern(hyp.lm_state, wlm);
                c.lm_state = lm_next_state(hyp.lm_state, wlm);
                c.score += opts.word_score;
              } else {
                auto [ns, d] = lm_extend(hyp.lm_state, w);
                c.lm_state = ns;
                c.lm_score += d;
                c.score += opts.lm_weight * d + opts.word_score;
              }
              c.node = 0;  // word complete: restart at root
            } else {
              c.node = it->second;
            }
          }
        } else {  // lexicon-free: token-level LM shallow fusion
          if (deferred && lm && opts.lm_weight != 0.0) {
            int32_t wlm = map_usr(tok);
            c.req = req_intern(hyp.lm_state, wlm);
            c.lm_state = lm_next_state(hyp.lm_state, wlm);
          } else {
            auto [ns, d] = lm_extend(hyp.lm_state, tok);
            c.lm_state = ns;
            c.lm_score += d;
            c.score += opts.lm_weight * d;
          }
        }
        pend.push_back(c);
      }
    }
    return (int)reqs.size();
  }

  // Phase 2: resolve pending LM scores, sort, prune, build the next beam.
  // Returns new beam size (0 = decoding done); out_toks/out_rows sized
  // >= beam_size by the caller.
  int step_apply(const float* scores, int32_t* out_toks, int32_t* out_rows) {
    std::vector<Cand> cands = std::move(pend);
    pend.clear();
    if (scores) {
      for (auto& c : cands) {
        if (c.req >= 0) {
          double s = scores[c.req];
          c.score += opts.lm_weight * s;
          c.lm_score += s;
        }
      }
    }
    if (cands.empty()) return 0;  // beam kept: end() falls back to it
    std::sort(cands.begin(), cands.end(),
              [](const Cand& a, const Cand& b) { return a.score > b.score; });
    double best = cands[0].score;
    size_t limit = cands.size();
    if (std::isfinite(opts.hard_selection))
      limit = std::min(limit, (size_t)std::max(
          1, (int)(opts.beam_size * opts.hard_selection)));
    std::vector<S2SHyp> nb;
    // arena indices of the old beam (parents) must survive arena growth
    std::vector<int> parent_entries(beam.size());
    for (size_t i = 0; i < beam.size(); i++) parent_entries[i] = beam[i].entry;
    for (size_t ci = 0; ci < limit && (int)nb.size() < opts.beam_size; ++ci) {
      const Cand& c = cands[ci];
      if (std::isfinite(opts.soft_selection) &&
          c.score < best - opts.soft_selection)
        break;  // cands sorted: everything after is also below the bar
      if (c.score < best - opts.beam_threshold) break;
      int e = (int)arena.size();
      arena.push_back(S2SEntry{parent_entries[c.src], c.token, c.word});
      nb.push_back(S2SHyp{c.score, c.am_score, c.lm_score, c.lm_state, c.node,
                          e, c.src, c.peak, c.token, false});
    }
    beam = std::move(nb);
    for (size_t i = 0; i < beam.size(); i++) {
      out_toks[i] = beam[i].last_tok;
      out_rows[i] = beam[i].row;
    }
    return (int)beam.size();
  }

  int step(const float* logp, const int32_t* peaks, int K, int V,
           int32_t* out_toks, int32_t* out_rows) {
    step_collect(logp, peaks, K, V);
    return step_apply(nullptr, out_toks, out_rows);
  }

  std::vector<int> end_reqs;

  int end_collect() {
    reqs.clear();
    req_idx.clear();
    was_completed = !finished.empty();
    if (finished.empty()) finished = beam;
    end_reqs.assign(finished.size(), -1);
    if (deferred && lm && opts.lm_weight != 0.0 && lm->eos_id >= 0) {
      for (size_t i = 0; i < finished.size(); i++)
        end_reqs[i] = req_intern(finished[i].lm_state, lm->eos_id);
    }
    return (int)reqs.size();
  }

  void end_apply(const float* scores) {
    if (lm && opts.lm_weight != 0.0 && lm->eos_id >= 0) {
      for (size_t i = 0; i < finished.size(); i++) {
        S2SHyp& h = finished[i];
        float s;
        if (deferred) {
          s = (scores && end_reqs[i] >= 0) ? scores[end_reqs[i]] : 0.f;
        } else {
          auto& hist = pool.states[h.lm_state];
          s = lm->score(hist.data(), (int)hist.size(), lm->eos_id);
        }
        h.score += opts.lm_weight * s;
        h.lm_score += s;
      }
    }
    std::sort(finished.begin(), finished.end(),
              [](const S2SHyp& a, const S2SHyp& b) { return a.score > b.score; });
    for (auto& h : finished) h.completed = was_completed;
  }

  void end() {
    end_collect();
    end_apply(nullptr);
  }

  void backtrack(const S2SHyp& h, std::vector<int32_t>& tokens,
                 std::vector<int32_t>& words) const {
    for (int e = h.entry; e >= 0; e = arena[e].parent) {
      tokens.push_back(arena[e].token);
      if (arena[e].word >= 0) words.push_back(arena[e].word);
    }
    std::reverse(tokens.begin(), tokens.end());
    std::reverse(words.begin(), words.end());
  }
};

// shared request exporter: hists is (cap_reqs, max_hist) row-major int32
template <typename D>
int export_reqs(D* d, int32_t* hists, int32_t* lens, int32_t* words,
                int max_hist) {
  int n = (int)d->reqs.size();
  for (int i = 0; i < n; i++) {
    const auto& [state, w] = d->reqs[i];
    const auto& h = d->pool.states[state];
    int L = std::min((int)h.size(), max_hist);
    for (int j = 0; j < L; j++) hists[(size_t)i * max_hist + j] = h[j];
    lens[i] = L;
    words[i] = w;
  }
  return n;
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------
extern "C" {

void* w2l_lm_load(const char* path) {
  // auto-detect: qt trie binary vs kenlm probing binary vs ARPA text
  if (is_qt_binary(path)) {
    auto* lm = new QtLM();
    if (!lm->load(path)) {
      std::fprintf(stderr, "w2l_lm_load: %s\n", lm->error.c_str());
      delete lm;
      return nullptr;
    }
    return static_cast<LMBase*>(lm);
  }
  if (is_kenlm_binary(path)) {
    auto* lm = new KenlmBinaryLM();
    if (!lm->load(path)) {
      std::fprintf(stderr, "w2l_lm_load: %s\n", lm->error.c_str());
      delete lm;
      return nullptr;
    }
    return static_cast<LMBase*>(lm);
  }
  auto* lm = new NgramLM();
  if (!lm->load_arpa(path)) {
    delete lm;
    return nullptr;
  }
  return static_cast<LMBase*>(lm);
}

int w2l_lm_used_mmap(void* ptr) {
  return static_cast<LMBase*>(ptr)->used_mmap();
}

// ARPA -> kenlm PROBING binary (build_binary equivalent); 1 on success
int w2l_lm_build_binary(const char* arpa, const char* out, float multiplier) {
  std::string err;
  if (multiplier < 1.0f) multiplier = 1.5f;
  if (!kenlm_build_binary(arpa, out, multiplier, &err)) {
    std::fprintf(stderr, "w2l_lm_build_binary: %s\n", err.c_str());
    return 0;
  }
  return 1;
}

// ARPA -> quantized trie binary (qt; small-footprint decode); 1 on success
int w2l_lm_build_trie(const char* arpa, const char* out) {
  std::string err;
  if (!qt_build_binary(arpa, out, &err)) {
    std::fprintf(stderr, "w2l_lm_build_trie: %s\n", err.c_str());
    return 0;
  }
  return 1;
}

int w2l_lm_order(void* lm_) { return static_cast<LMBase*>(lm_)->order; }

// log10 P(w | hist); hist = LM word ids, oldest first
float w2l_lm_score_hist(void* lm_, const int32_t* hist, int hn, int32_t w) {
  return static_cast<LMBase*>(lm_)->score(hist, hn, w);
}

int w2l_lm_bos_id(void* lm_) { return static_cast<LMBase*>(lm_)->bos_id; }
int w2l_lm_eos_id(void* lm_) { return static_cast<LMBase*>(lm_)->eos_id; }

void w2l_lm_free(void* lm) { delete static_cast<LMBase*>(lm); }

int w2l_lm_word_id(void* lm_, const char* word) {
  return static_cast<LMBase*>(lm_)->find_word(word);
}

int w2l_lm_unk_id(void* lm_) { return static_cast<LMBase*>(lm_)->unk_id; }

float w2l_lm_score_seq(void* lm_, const int32_t* ids, int n) {
  // sentence log10 prob incl. </s> (utility / perplexity checks)
  auto* lm = static_cast<LMBase*>(lm_);
  std::vector<int32_t> hist;
  if (lm->bos_id >= 0) hist.push_back(lm->bos_id);
  float total = 0;
  for (int i = 0; i < n; i++) {
    total += lm->score(hist.data(), (int)hist.size(), ids[i]);
    hist.push_back(ids[i]);
    int keep = std::max(0, lm->order - 1);
    if ((int)hist.size() > keep) hist.erase(hist.begin(), hist.end() - keep);
  }
  if (lm->eos_id >= 0)
    total += lm->score(hist.data(), (int)hist.size(), lm->eos_id);
  return total;
}

void* w2l_trie_new() { return new Trie(); }
void w2l_trie_free(void* t) { delete static_cast<Trie*>(t); }

void w2l_trie_insert(void* t, const int32_t* toks, int n, int word, float score) {
  static_cast<Trie*>(t)->insert(toks, n, word, score);
}

void w2l_trie_smear(void* t, int mode) { static_cast<Trie*>(t)->smear(mode); }

void* w2l_decoder_new(
    int beam_size, int beam_size_token, double beam_threshold,
    double lm_weight, double word_score, double unk_score, double sil_score,
    int log_add, int criterion, void* trie, void* lm, int sil, int blank,
    int unk_word, const float* transitions, int n_tokens,
    const int32_t* usr_to_lm, int n_usr, int is_token_lm) {
  auto* d = new Decoder();
  d->opts = {beam_size, beam_size_token, beam_threshold, lm_weight,
             word_score,
             unk_score > 1e29 || unk_score < -1e29 ? kNegInf : unk_score,
             sil_score, log_add, criterion};
  if (unk_score <= -1e29) d->opts.unk_score = kNegInf;
  d->trie = static_cast<Trie*>(trie);
  d->lm = static_cast<LMBase*>(lm);
  d->deferred = dynamic_cast<ExternalLM*>(d->lm) != nullptr;
  d->sil = sil;
  d->blank = blank;
  d->unk_word = unk_word;
  d->n_tokens = n_tokens;
  d->is_token_lm = is_token_lm != 0;
  if (transitions) d->transitions.assign(transitions, transitions + n_tokens * n_tokens);
  if (usr_to_lm && n_usr > 0) d->usr_to_lm.assign(usr_to_lm, usr_to_lm + n_usr);
  return d;
}

void w2l_decoder_free(void* d) { delete static_cast<Decoder*>(d); }

// -- deferred (host-scored / ConvLM) LM support -----------------------------

// An LM whose scores the host computes in batches (neural LM on the TPU).
// context = history truncation length (the model's receptive field).
void* w2l_lm_new_external(int context, int bos, int eos, int unk) {
  return static_cast<LMBase*>(new ExternalLM(context, bos, eos, unk));
}

// Process ONE emission frame, phase 1: generate candidates; returns the
// number of pending LM score requests (0 with a sync/absent LM).
int w2l_decoder_step_collect(void* d_, const float* em_frame, int n) {
  auto* d = static_cast<Decoder*>(d_);
  (void)n;
  return d->step_collect(em_frame);
}

// Fetch pending requests: for request i, hists[i,:lens[i]] = LM-word-id
// history (oldest first), words[i] = LM word id to score. Returns count.
int w2l_decoder_reqs_export(void* d_, int32_t* hists, int32_t* lens,
                            int32_t* words, int max_hist) {
  return export_reqs(static_cast<Decoder*>(d_), hists, lens, words, max_hist);
}

// Phase 2: apply host scores (log10, one per request; NULL ok when no
// requests) — merges, thresholds, prunes, closes the frame.
void w2l_decoder_step_apply(void* d_, const float* scores) {
  static_cast<Decoder*>(d_)->step_apply(scores);
}

int w2l_decoder_end_collect(void* d_) {
  return static_cast<Decoder*>(d_)->end_collect();
}

void w2l_decoder_end_apply(void* d_, const float* scores) {
  static_cast<Decoder*>(d_)->end_apply(scores);
}

void w2l_decoder_begin(void* d) { static_cast<Decoder*>(d)->begin(); }

void w2l_decoder_step(void* d_, const float* emissions, int t, int n) {
  auto* d = static_cast<Decoder*>(d_);
  for (int i = 0; i < t; i++) d->step_frame(emissions + (size_t)i * n);
}

void w2l_decoder_end(void* d) { static_cast<Decoder*>(d)->end(); }

int w2l_decoder_nhyps(void* d_) {
  auto* d = static_cast<Decoder*>(d_);
  return (int)d->frames.back().size();
}

// fills tokens/words (caller allocates T ints each); returns length; score
// trio written to score_out[3] = {score, am, lm}
int w2l_decoder_result(void* d_, int hyp_idx, int32_t* tokens, int32_t* words,
                       int max_len, double* score_out) {
  auto* d = static_cast<Decoder*>(d_);
  const auto& fin = d->frames.back();
  if (hyp_idx >= (int)fin.size()) return -1;
  std::vector<int> tk, wd;
  d->backtrack(hyp_idx, tk, wd);
  int L = std::min((int)tk.size(), max_len);
  for (int i = 0; i < L; i++) {
    tokens[i] = tk[i];
    words[i] = wd[i];
  }
  score_out[0] = fin[hyp_idx].score;
  score_out[1] = fin[hyp_idx].am_score;
  score_out[2] = fin[hyp_idx].lm_score;
  return L;
}

// best hypothesis ending `look_back` frames before the newest frame
// (reference getBestHypothesis(lookBack), inference/decoder/Decoder.cpp:
// 227-261): the stable prefix an online consumer prints. Pair with
// w2l_decoder_prune(look_back) — which re-roots at the SAME frame — for
// duplicate-free per-chunk word consumption (AudioToWords.cpp:64-105).
int w2l_decoder_best_lookback(void* d_, int look_back, int32_t* tokens,
                              int32_t* words, int max_len,
                              double* score_out) {
  auto* d = static_cast<Decoder*>(d_);
  int T = (int)d->frames.size() - 1;
  if (T < 1) return 0;
  int tf = d->ended ? T : std::max(1, T - look_back);
  const auto& fr = d->frames[tf];
  if (fr.empty()) return 0;
  int best = 0;
  for (int i = 1; i < (int)fr.size(); i++)
    if (fr[i].score > fr[best].score) best = i;
  std::vector<int> tk, wd;
  if (d->ended && tf == T) {
    d->backtrack(best, tk, wd);
  } else {
    int fi = best;
    for (int t = tf; t >= 1; t--) {
      const Hyp& cur = d->frames[t][fi];
      tk.push_back(cur.token);
      wd.push_back(cur.word);
      fi = cur.parent;
      if (fi < 0) break;
    }
    std::reverse(tk.begin(), tk.end());
    std::reverse(wd.begin(), wd.end());
  }
  int L = std::min((int)tk.size(), max_len);
  for (int i = 0; i < L; i++) {
    tokens[i] = tk[i];
    words[i] = wd[i];
  }
  if (score_out) {
    score_out[0] = fr[best].score;
    score_out[1] = fr[best].am_score;
    score_out[2] = fr[best].lm_score;
  }
  return L;
}

// prune lattice keeping last (look_back+1) frames (online API)
void w2l_decoder_prune(void* d_, int look_back) {
  auto* d = static_cast<Decoder*>(d_);
  int keep_from = std::max(0, (int)d->frames.size() - 1 - look_back);
  if (keep_from == 0) return;
  // materialize best path prefix is the caller's job (get_best before prune);
  // we re-root: collapse frames[0..keep_from] into a single frame whose hyps
  // are frames[keep_from] with parent = -1.
  std::vector<std::vector<Hyp>> nf;
  nf.push_back(d->frames[keep_from]);
  for (auto& h : nf[0]) h.parent = -1;
  for (size_t t = keep_from + 1; t < d->frames.size(); t++)
    nf.push_back(std::move(d->frames[t]));
  d->frames = std::move(nf);
}

// -- seq2seq beam ----------------------------------------------------------

void* w2l_s2s_new(int beam_size, int beam_size_token, double beam_threshold,
                  double lm_weight, double word_score, double eos_score,
                  double attention_threshold, double hard_selection,
                  double soft_selection, void* trie, void* lm, int eos_idx,
                  int word_sep, const int32_t* usr_to_lm, int n_usr) {
  auto* d = new S2SDecoder();
  d->opts.beam_size = beam_size;
  d->opts.beam_size_token = beam_size_token > 0 ? beam_size_token : (1 << 30);
  d->opts.beam_threshold = beam_threshold;
  d->opts.lm_weight = lm_weight;
  d->opts.word_score = word_score;
  d->opts.eos_score = eos_score;
  d->opts.attention_threshold =
      attention_threshold >= 1e29 ? kInf : attention_threshold;
  d->opts.hard_selection = hard_selection >= 1e29 ? kInf : hard_selection;
  d->opts.soft_selection = soft_selection >= 1e29 ? kInf : soft_selection;
  d->trie = static_cast<Trie*>(trie);
  d->lm = static_cast<LMBase*>(lm);
  d->deferred = dynamic_cast<ExternalLM*>(d->lm) != nullptr;
  d->eos = eos_idx;
  d->word_sep = word_sep;
  if (usr_to_lm && n_usr > 0) d->usr_to_lm.assign(usr_to_lm, usr_to_lm + n_usr);
  return d;
}

void w2l_s2s_free(void* d) { delete static_cast<S2SDecoder*>(d); }

void w2l_s2s_begin(void* d) { static_cast<S2SDecoder*>(d)->begin(); }

int w2l_s2s_step(void* d_, const float* logp, const int32_t* peaks, int K,
                 int V, int32_t* out_toks, int32_t* out_rows) {
  return static_cast<S2SDecoder*>(d_)->step(logp, peaks, K, V, out_toks,
                                            out_rows);
}

void w2l_s2s_end(void* d) { static_cast<S2SDecoder*>(d)->end(); }

// -- deferred-LM variants (see w2l_decoder_step_collect) --------------------

int w2l_s2s_step_collect(void* d_, const float* logp, const int32_t* peaks,
                         int K, int V) {
  return static_cast<S2SDecoder*>(d_)->step_collect(logp, peaks, K, V);
}

int w2l_s2s_reqs_export(void* d_, int32_t* hists, int32_t* lens,
                        int32_t* words, int max_hist) {
  return export_reqs(static_cast<S2SDecoder*>(d_), hists, lens, words,
                     max_hist);
}

int w2l_s2s_step_apply(void* d_, const float* scores, int32_t* out_toks,
                       int32_t* out_rows) {
  return static_cast<S2SDecoder*>(d_)->step_apply(scores, out_toks, out_rows);
}

int w2l_s2s_end_collect(void* d_) {
  return static_cast<S2SDecoder*>(d_)->end_collect();
}

void w2l_s2s_end_apply(void* d_, const float* scores) {
  static_cast<S2SDecoder*>(d_)->end_apply(scores);
}

int w2l_s2s_nhyps(void* d_) {
  return (int)static_cast<S2SDecoder*>(d_)->finished.size();
}

// fills tokens/words; returns token count (words count goes to n_words);
// score_out[3] = {score, am, lm}; completed flag to *completed
int w2l_s2s_result(void* d_, int hyp_idx, int32_t* tokens, int32_t* words,
                   int max_len, double* score_out, int32_t* n_words,
                   int32_t* completed) {
  auto* d = static_cast<S2SDecoder*>(d_);
  if (hyp_idx >= (int)d->finished.size()) return -1;
  const auto& h = d->finished[hyp_idx];
  std::vector<int32_t> tk, wd;
  d->backtrack(h, tk, wd);
  int L = std::min((int)tk.size(), max_len);
  for (int i = 0; i < L; i++) tokens[i] = tk[i];
  int W = std::min((int)wd.size(), max_len);
  for (int i = 0; i < W; i++) words[i] = wd[i];
  *n_words = W;
  score_out[0] = h.score;
  score_out[1] = h.am_score;
  score_out[2] = h.lm_score;
  *completed = h.completed ? 1 : 0;
  return L;
}

}  // extern "C"
