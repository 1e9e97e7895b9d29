// wmpump — threaded frame pump for the video pipeline.
//
// Replacement for the reference's synchronous pinned-buffer frame
// loop (/root/reference/Watermark_GPU/main.cpp:271-275,319-340): a reader
// thread prefetches fixed-size frames from a file descriptor (raw .yuv file
// or an ffmpeg rawvideo pipe) into a ring of buffers so decode overlaps
// device compute, and a writer thread drains an output ring so encode
// overlaps as well. Exposed as a C API for ctypes.
//
// Build: make -C native   (g++ -O3 -shared -fPIC -pthread)

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <errno.h>
#include <unistd.h>

namespace {

// Read exactly n bytes (loop over short reads). Returns bytes read; fewer
// than n means EOF (or error when < 0 semantics via errno are not needed —
// partial trailing frames are dropped by callers).
ssize_t read_full(int fd, uint8_t* dst, size_t n) {
    size_t off = 0;
    while (off < n) {
        ssize_t r = read(fd, dst + off, n - off);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        if (r == 0) break;
        off += static_cast<size_t>(r);
    }
    return static_cast<ssize_t>(off);
}

ssize_t write_full(int fd, const uint8_t* src, size_t n) {
    size_t off = 0;
    while (off < n) {
        ssize_t r = write(fd, src + off, n - off);
        if (r < 0) {
            if (errno == EINTR) continue;
            return -1;
        }
        off += static_cast<size_t>(r);
    }
    return static_cast<ssize_t>(off);
}

struct Ring {
    std::mutex mu;
    std::condition_variable cv_put, cv_get;
    std::deque<std::vector<uint8_t>> full;
    std::deque<std::vector<uint8_t>> empty;
    bool done = false;   // producer finished / consumer closed
    bool error = false;
};

struct Reader {
    int fd;
    size_t frame_bytes;
    Ring ring;
    std::thread thread;

    void run() {
        for (;;) {
            std::vector<uint8_t> buf;
            {
                std::unique_lock<std::mutex> lk(ring.mu);
                ring.cv_put.wait(lk, [&] {
                    return !ring.empty.empty() || ring.done;
                });
                if (ring.done) return;
                buf = std::move(ring.empty.front());
                ring.empty.pop_front();
            }
            ssize_t got = read_full(fd, buf.data(), frame_bytes);
            std::unique_lock<std::mutex> lk(ring.mu);
            if (got == static_cast<ssize_t>(frame_bytes)) {
                ring.full.push_back(std::move(buf));
                ring.cv_get.notify_one();
            } else {
                if (got < 0) ring.error = true;
                ring.done = true;          // EOF or partial trailing frame
                ring.cv_get.notify_all();
                return;
            }
        }
    }
};

struct Writer {
    int fd;
    size_t frame_bytes;
    Ring ring;
    std::thread thread;

    void run() {
        for (;;) {
            std::vector<uint8_t> buf;
            {
                std::unique_lock<std::mutex> lk(ring.mu);
                ring.cv_get.wait(lk, [&] {
                    return !ring.full.empty() || ring.done;
                });
                if (ring.full.empty()) return;   // done && drained
                buf = std::move(ring.full.front());
                ring.full.pop_front();
            }
            ssize_t put = write_full(fd, buf.data(), frame_bytes);
            std::unique_lock<std::mutex> lk(ring.mu);
            if (put != static_cast<ssize_t>(frame_bytes)) {
                ring.error = true;
                ring.done = true;
                ring.cv_put.notify_all();
                return;
            }
            ring.empty.push_back(std::move(buf));
            ring.cv_put.notify_one();
        }
    }
};

}  // namespace

extern "C" {

void* wmp_reader_open(int fd, size_t frame_bytes, int depth) {
    auto* r = new Reader{fd, frame_bytes, {}, {}};
    for (int i = 0; i < depth; i++)
        r->ring.empty.emplace_back(frame_bytes);
    r->thread = std::thread([r] { r->run(); });
    return r;
}

// 1 = frame copied to dst, 0 = clean EOF, -1 = IO error.
int wmp_reader_next(void* handle, uint8_t* dst) {
    auto* r = static_cast<Reader*>(handle);
    std::unique_lock<std::mutex> lk(r->ring.mu);
    r->ring.cv_get.wait(lk, [&] {
        return !r->ring.full.empty() || r->ring.done;
    });
    if (r->ring.full.empty())
        return r->ring.error ? -1 : 0;
    std::vector<uint8_t> buf = std::move(r->ring.full.front());
    r->ring.full.pop_front();
    memcpy(dst, buf.data(), r->frame_bytes);
    r->ring.empty.push_back(std::move(buf));
    r->ring.cv_put.notify_one();
    return 1;
}

void wmp_reader_close(void* handle) {
    auto* r = static_cast<Reader*>(handle);
    {
        std::unique_lock<std::mutex> lk(r->ring.mu);
        r->ring.done = true;
        r->ring.cv_put.notify_all();
    }
    if (r->thread.joinable()) r->thread.join();
    delete r;
}

void* wmp_writer_open(int fd, size_t frame_bytes, int depth) {
    auto* w = new Writer{fd, frame_bytes, {}, {}};
    for (int i = 0; i < depth; i++)
        w->ring.empty.emplace_back(frame_bytes);
    w->thread = std::thread([w] { w->run(); });
    return w;
}

// 1 = enqueued, -1 = downstream IO error.
int wmp_writer_put(void* handle, const uint8_t* src) {
    auto* w = static_cast<Writer*>(handle);
    std::unique_lock<std::mutex> lk(w->ring.mu);
    w->ring.cv_put.wait(lk, [&] {
        return !w->ring.empty.empty() || w->ring.done;
    });
    if (w->ring.done) return -1;
    std::vector<uint8_t> buf = std::move(w->ring.empty.front());
    w->ring.empty.pop_front();
    memcpy(buf.data(), src, w->frame_bytes);
    w->ring.full.push_back(std::move(buf));
    w->ring.cv_get.notify_one();
    return 1;
}

// Blocks until everything queued has been written. Returns 0 ok, -1 error.
int wmp_writer_close(void* handle) {
    auto* w = static_cast<Writer*>(handle);
    {
        std::unique_lock<std::mutex> lk(w->ring.mu);
        w->ring.done = true;
        w->ring.cv_get.notify_all();
    }
    if (w->thread.joinable()) w->thread.join();
    int rc = w->ring.error ? -1 : 0;
    delete w;
    return rc;
}

}  // extern "C"
