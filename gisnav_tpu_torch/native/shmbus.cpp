// Shared-memory pub/sub ring bus — the framework's intra-host transport.
//
// Replaces the reference's DDS (Fast DDS over /dev/shm,
// docker-compose.ros.yaml:14-21 in hmakelin/gisnav) for the node graph:
// single-writer multi-reader topics over POSIX shared memory with a
// seqlock-style slot protocol. No broker, no discovery daemon: a topic IS a
// shm segment, readers poll (or block with an adaptive backoff wait).
//
// Slot protocol (single writer):
//   - writer picks slot = seq % nslots, bumps slot.seq to an ODD value
//     (write in progress), memcpy payload, stores length, then bumps
//     slot.seq to 2*(seq+1) (even: committed) and finally publishes the
//     global head sequence with release ordering.
//   - readers read head with acquire ordering, copy the slot, then verify
//     the slot seq did not change mid-copy (seqlock re-check). A reader that
//     falls behind by more than nslots drops old messages (latest-wins, like
//     a shallow-QoS sensor-data subscription).
//
// The port's own copy of gisnav_tpu/native/shmbus.cpp: the same segment
// layout, magic and slot protocol, so a JAX graph and a port graph in one
// namespace share segments. Built at first use as a small C library (no C++
// runtime types in the ABI) with the host compiler and bound from Python
// with ctypes (gisnav_tpu_torch/nodes/bus.py build_native_lib).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <signal.h>

namespace {

constexpr uint64_t kMagic = 0x47495342'55533031ULL;  // "GISBUS01"

struct SlotHeader {
  std::atomic<uint64_t> seq;   // odd: write in progress; even: committed
  std::atomic<uint64_t> len;   // payload length
  uint64_t stamp_us;           // publisher wall-clock stamp
};

struct BusHeader {
  std::atomic<uint64_t> magic;
  uint64_t nslots;
  uint64_t slot_size;
  std::atomic<uint64_t> head;       // number of committed messages
  std::atomic<uint64_t> writer_pid; // single-writer lock (0 = free)
  char name[64];
};

struct Bus {
  BusHeader* header;
  uint8_t* slots;  // nslots * (sizeof(SlotHeader) + slot_size)
  size_t map_size;
  int fd;
};

inline SlotHeader* slot_at(Bus* bus, uint64_t idx) {
  const size_t stride = sizeof(SlotHeader) + bus->header->slot_size;
  return reinterpret_cast<SlotHeader*>(bus->slots + idx * stride);
}

inline uint8_t* slot_payload(SlotHeader* slot) {
  return reinterpret_cast<uint8_t*>(slot + 1);
}

uint64_t now_us() {
  timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000ULL + ts.tv_nsec / 1000ULL;
}

}  // namespace

extern "C" {

// Create (or open existing) a topic segment. Returns nullptr on failure.
//
// Init race: only the process that wins O_CREAT|O_EXCL initializes; every
// racer waits until the segment reaches full size AND the magic is
// published with release ordering. Two processes can therefore never
// re-initialize over each other (the round-1 bug: both observed
// magic != kMagic on a shared O_CREAT fd and both wrote the header).
void* shmbus_create(const char* name, uint64_t nslots, uint64_t slot_size) {
  const size_t map_size =
      sizeof(BusHeader) + nslots * (sizeof(SlotHeader) + slot_size);
  bool initializer = true;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    if (errno != EEXIST) return nullptr;
    initializer = false;
    fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
  }
  if (initializer) {
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    // wait (~2 s max) for the initializer's ftruncate
    for (int spin = 0; spin < 20000; ++spin) {
      struct stat st;
      if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
      }
      if (static_cast<size_t>(st.st_size) >= map_size) break;
      timespec ts{0, 100000};  // 0.1 ms
      nanosleep(&ts, nullptr);
    }
  }
  void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Bus* bus = new Bus();
  bus->header = static_cast<BusHeader*>(mem);
  bus->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(BusHeader);
  bus->map_size = map_size;
  bus->fd = fd;
  if (initializer) {
    bus->header->nslots = nslots;
    bus->header->slot_size = slot_size;
    bus->header->head.store(0, std::memory_order_relaxed);
    bus->header->writer_pid.store(0, std::memory_order_relaxed);
    strncpy(bus->header->name, name, sizeof(bus->header->name) - 1);
    bus->header->magic.store(kMagic, std::memory_order_release);
  } else {
    // wait for the initializer to publish the header
    for (int spin = 0; spin < 20000; ++spin) {
      if (bus->header->magic.load(std::memory_order_acquire) == kMagic) break;
      timespec ts{0, 100000};
      nanosleep(&ts, nullptr);
    }
    if (bus->header->magic.load(std::memory_order_acquire) != kMagic) {
      munmap(mem, map_size);
      close(fd);
      delete bus;
      return nullptr;
    }
  }
  return bus;
}

// Open an existing topic segment for reading/writing. Null on failure.
void* shmbus_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (off_t)sizeof(BusHeader)) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  Bus* bus = new Bus();
  bus->header = static_cast<BusHeader*>(mem);
  bus->slots = reinterpret_cast<uint8_t*>(mem) + sizeof(BusHeader);
  bus->map_size = st.st_size;
  bus->fd = fd;
  if (bus->header->magic.load(std::memory_order_acquire) != kMagic) {
    munmap(mem, st.st_size);
    close(fd);
    delete bus;
    return nullptr;
  }
  return bus;
}

// Enforce the single-writer-per-topic contract: the first publisher CAS-es
// its pid into the header; a stale lock (dead process) is taken over.
// Returns 1 when this process holds the write lock, 0 otherwise.
int shmbus_writer_acquire(void* handle) {
  Bus* bus = static_cast<Bus*>(handle);
  const uint64_t me = static_cast<uint64_t>(getpid());
  uint64_t cur = bus->header->writer_pid.load(std::memory_order_acquire);
  if (cur == me) return 1;
  if (cur != 0) {
    // take over only if the holder is gone
    if (kill(static_cast<pid_t>(cur), 0) == 0 || errno != ESRCH) return 0;
    if (!bus->header->writer_pid.compare_exchange_strong(
            cur, me, std::memory_order_acq_rel)) {
      return bus->header->writer_pid.load(std::memory_order_acquire) == me;
    }
    return 1;
  }
  uint64_t expect = 0;
  if (bus->header->writer_pid.compare_exchange_strong(
          expect, me, std::memory_order_acq_rel)) {
    return 1;
  }
  return bus->header->writer_pid.load(std::memory_order_acquire) == me;
}

void shmbus_writer_release(void* handle) {
  Bus* bus = static_cast<Bus*>(handle);
  uint64_t me = static_cast<uint64_t>(getpid());
  bus->header->writer_pid.compare_exchange_strong(
      me, 0, std::memory_order_acq_rel);
}

// Publish one message. Returns the new head sequence, or 0 on failure
// (payload too large, or another live process holds the write lock).
uint64_t shmbus_publish(void* handle, const uint8_t* data, uint64_t len) {
  Bus* bus = static_cast<Bus*>(handle);
  if (len > bus->header->slot_size) return 0;
  if (!shmbus_writer_acquire(handle)) return 0;
  const uint64_t seq = bus->header->head.load(std::memory_order_relaxed);
  SlotHeader* slot = slot_at(bus, seq % bus->header->nslots);
  slot->seq.store(2 * seq + 1, std::memory_order_release);  // odd: writing
  memcpy(slot_payload(slot), data, len);
  slot->len.store(len, std::memory_order_relaxed);
  slot->stamp_us = now_us();
  slot->seq.store(2 * (seq + 1), std::memory_order_release);  // committed
  bus->header->head.store(seq + 1, std::memory_order_release);
  return seq + 1;
}

// Current head sequence (number of messages ever published).
uint64_t shmbus_head(void* handle) {
  Bus* bus = static_cast<Bus*>(handle);
  return bus->header->head.load(std::memory_order_acquire);
}

// Read message with sequence number `seq` (0-based: the (seq+1)-th message).
// Returns payload length, 0 if not yet published, or UINT64_MAX if the slot
// was already overwritten (reader too slow — skip forward).
uint64_t shmbus_read(void* handle, uint64_t seq, uint8_t* out,
                     uint64_t out_cap, uint64_t* stamp_us) {
  Bus* bus = static_cast<Bus*>(handle);
  const uint64_t head = bus->header->head.load(std::memory_order_acquire);
  if (seq >= head) return 0;  // not yet published
  if (head - seq > bus->header->nslots) return UINT64_MAX;  // overwritten
  SlotHeader* slot = slot_at(bus, seq % bus->header->nslots);
  const uint64_t expect = 2 * (seq + 1);
  uint64_t s1 = slot->seq.load(std::memory_order_acquire);
  if (s1 != expect) return UINT64_MAX;  // overwritten or in flight
  const uint64_t len = slot->len.load(std::memory_order_relaxed);
  if (len > out_cap) return UINT64_MAX;
  memcpy(out, slot_payload(slot), len);
  if (stamp_us) *stamp_us = slot->stamp_us;
  std::atomic_thread_fence(std::memory_order_acquire);
  const uint64_t s2 = slot->seq.load(std::memory_order_acquire);
  if (s2 != expect) return UINT64_MAX;  // torn read
  return len;
}

uint64_t shmbus_slot_size(void* handle) {
  return static_cast<Bus*>(handle)->header->slot_size;
}

void shmbus_close(void* handle) {
  Bus* bus = static_cast<Bus*>(handle);
  munmap(bus->header, bus->map_size);
  close(bus->fd);
  delete bus;
}

// Remove the backing segment (call on teardown of the owning process).
int shmbus_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
