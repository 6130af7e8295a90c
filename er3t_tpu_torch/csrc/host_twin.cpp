// The per-lane bodies of flight_post.cu and domain_tally.cu built for the
// host: the lanes in order, the tallies and counters added one lane at a
// time.  Not kernels of the port: the CPU tests build this file with a
// host C++ compiler (-ffp-contract=off, so no FMA either side of the
// comparison; tests/test_torch_fused_post.py gives the command) and hold
// it against the plain PyTorch versions, which the card kernels are held
// against on the card.

#include "domain_tally.cuh"
#include "flight_post.cuh"

namespace {

using er3t::post::PostArgs;
using er3t::tally::TallyArgs;

struct PostSink {
  const PostArgs* a;
  void deposit(int pix, float v) { a->rad[pix] += v; }
  void absorb(int k, float v) { a->absorbed[k] += v; }
};

struct TallySink {
  const TallyArgs* a;
  void add_flux(int k, float v) { a->flux[k] += v; }
  void add_absorbed(int k, float v) { a->absorbed[k] += v; }
};

}  // namespace

extern "C" int er3t_flight_post(const PostArgs* args, void* stream) {
  (void)stream;
  const PostArgs& a = *args;
  if (a.o_launched != nullptr) *a.o_launched = *a.launched;
  PostSink sink{&a};
  for (int i = 0; i < a.n; ++i) {
    const unsigned bits = er3t::post::post_lane(a, i, sink);
    for (int k = 0; k < er3t::post::kCounterBits; ++k) {
      int64_t* c = er3t::post::counter_of(a, k);
      if (c != nullptr && ((bits >> k) & 1u)) *c += 1;
    }
  }
  return 0;
}

extern "C" int er3t_flight_post_args_size(void* stream) {
  (void)stream;
  return (int)sizeof(PostArgs);
}

extern "C" int er3t_domain_tally(const TallyArgs* args, void* stream) {
  (void)stream;
  TallySink sink{args};
  for (int i = 0; i < args->n; ++i)
    for (int g = 0; g < args->ng; ++g)
      er3t::tally::tally_lane_g(*args, i, g, sink);
  return 0;
}

extern "C" int er3t_domain_tally_args_size(void* stream) {
  (void)stream;
  return (int)sizeof(TallyArgs);
}
