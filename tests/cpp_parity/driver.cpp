// Cross-parity driver: trains and evaluates the REFERENCE libforest
// (compiled from /root/reference/third-party/libforest, unmodified) on a raw
// binary dataset, dumping forest.dat and per-point log-posteriors so the JAX
// rebuild's codec, descent kernel, and trainer can be validated against the
// original C++:
//   - descent/posterior semantics: classifier.cpp:97-131,166-208
//   - binary forest format:        io.h:34-108, classifier.cpp:134-152,210-235
//   - learner semantics:           learning.cpp:363-1113
//
// Usage:
//   driver train   <data.bin> <forest.dat> <num_trees> <max_depth> <min_split>
//   driver predict <forest.dat> <data.bin> <post.bin>
//
// data.bin: int32 N, D, L; then N*D float32 features (row-major);
//           then N*L int32 labels. L==1 -> single-label mode, else multi.
// post.bin: int32 N, L, C_0..C_{L-1}; then per point, per layer, C_l float32.
//
// This file is ORIGINAL code for the JAX rebuild's test suite (it plays the
// role of libforest's example/main.cpp without reusing it).

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <vector>

#include "libforest/libforest.h"

namespace {

struct RawData {
  int n = 0, d = 0, l = 0;
  std::vector<float> x;             // n*d
  std::vector<std::int32_t> y;      // n*l
};

RawData loadRaw(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    std::cerr << "cannot open " << path << std::endl;
    std::exit(2);
  }
  RawData r;
  std::int32_t hdr[3];
  f.read(reinterpret_cast<char*>(hdr), sizeof(hdr));
  r.n = hdr[0];
  r.d = hdr[1];
  r.l = hdr[2];
  r.x.resize(static_cast<size_t>(r.n) * r.d);
  r.y.resize(static_cast<size_t>(r.n) * r.l);
  f.read(reinterpret_cast<char*>(r.x.data()), r.x.size() * sizeof(float));
  f.read(reinterpret_cast<char*>(r.y.data()),
         r.y.size() * sizeof(std::int32_t));
  if (!f) {
    std::cerr << "truncated data file " << path << std::endl;
    std::exit(2);
  }
  return r;
}

// Fill a DataStorage the way src/train.cpp:89-223 does (via
// FeatureExtractor::extract -> addDataPoint[Multi]).
void fillStorage(const RawData& r, libf::DataStorage& storage) {
  for (int i = 0; i < r.n; ++i) {
    auto* p = new libf::DataPoint(r.d);
    for (int j = 0; j < r.d; ++j) p->at(j) = r.x[static_cast<size_t>(i) * r.d + j];
    if (r.l == 1) {
      storage.addDataPoint(p, r.y[i], true);
    } else {
      std::vector<int> labels(r.l);
      for (int q = 0; q < r.l; ++q)
        labels[q] = r.y[static_cast<size_t>(i) * r.l + q];
      storage.addDataPointMulti(p, labels, true);
    }
  }
}

int runTrain(int argc, char** argv) {
  if (argc != 7) return 1;
  const RawData data = loadRaw(argv[2]);
  const std::string out = argv[3];
  const int numTrees = std::atoi(argv[4]);
  const int maxDepth = std::atoi(argv[5]);
  const int minSplit = std::atoi(argv[6]);
  const bool multi = data.l > 1;

  libf::DataStorage storage = multi ? libf::DataStorage(data.l)
                                    : libf::DataStorage();
  fillStorage(data, storage);

  // Mirror src/train.cpp:226-239 exactly.
  libf::DecisionTreeLearner treeLearner;
  treeLearner.autoconf(&storage);
  treeLearner.setUseBootstrap(true);
  treeLearner.setMaxDepth(maxDepth);
  treeLearner.setMinSplitExamples(minSplit);
  treeLearner.setUseClassFrequency(false);
  treeLearner.useMultiLabelLayers(multi);
  libf::RandomForestLearner forestLearner;
  forestLearner.setTreeLearner(&treeLearner);
  forestLearner.setNumTrees(numTrees);
  forestLearner.setNumThreads(8);

  const auto t0 = std::chrono::steady_clock::now();
  libf::RandomForest* forest = forestLearner.learn(&storage);
  const auto t1 = std::chrono::steady_clock::now();
  std::printf("TRAIN_SECONDS %.3f\n",
              std::chrono::duration<double>(t1 - t0).count());

  std::filebuf fb;
  if (!fb.open(out, std::ios::out | std::ios::binary)) {
    std::cerr << "cannot write " << out << std::endl;
    return 2;
  }
  std::ostream os(&fb);
  forest->write(os);
  fb.close();
  delete forest;
  return 0;
}

int runPredict(int argc, char** argv) {
  if (argc != 5) return 1;
  libf::RandomForest forest;
  {
    std::filebuf fb;
    if (!fb.open(argv[2], std::ios::in | std::ios::binary)) {
      std::cerr << "cannot read " << argv[2] << std::endl;
      return 2;
    }
    std::istream is(&fb);
    forest.read(is);
  }
  const RawData data = loadRaw(argv[3]);
  const bool multi = data.l > 1;

  std::ofstream out(argv[4], std::ios::binary);
  std::vector<std::int32_t> header;
  std::vector<float> flat;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < data.n; ++i) {
    libf::DataPoint p(data.d);
    for (int j = 0; j < data.d; ++j)
      p.at(j) = data.x[static_cast<size_t>(i) * data.d + j];
    if (multi) {
      std::vector<std::vector<float>> post;
      forest.multiClassLogPosterior(&p, post);
      if (header.empty()) {
        header = {data.n, static_cast<std::int32_t>(post.size())};
        for (const auto& layer : post)
          header.push_back(static_cast<std::int32_t>(layer.size()));
      }
      for (const auto& layer : post)
        flat.insert(flat.end(), layer.begin(), layer.end());
    } else {
      std::vector<float> post;
      forest.classLogPosterior(&p, post);
      if (header.empty())
        header = {data.n, 1, static_cast<std::int32_t>(post.size())};
      flat.insert(flat.end(), post.begin(), post.end());
    }
  }
  const auto t1 = std::chrono::steady_clock::now();
  std::printf("PREDICT_SECONDS %.3f\n",
              std::chrono::duration<double>(t1 - t0).count());
  out.write(reinterpret_cast<const char*>(header.data()),
            header.size() * sizeof(std::int32_t));
  out.write(reinterpret_cast<const char*>(flat.data()),
            flat.size() * sizeof(float));
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc >= 2 && std::strcmp(argv[1], "train") == 0)
    return runTrain(argc, argv);
  if (argc >= 2 && std::strcmp(argv[1], "predict") == 0)
    return runPredict(argc, argv);
  std::cerr << "usage: driver train|predict ..." << std::endl;
  return 1;
}
