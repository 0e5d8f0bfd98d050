// Native host-side runtime pieces: V4L2 camera capture and a low-latency
// UDP multicast bus.
//
// The reference's native layer exists to feed its GPU pipeline with
// zero-copy camera frames and to run the SSL multicast bus off the hot path
// (reference src/driver/*, src/udpsocket.*). This build keeps the same
// split: XLA owns the device compute, and this library owns the
// latency-sensitive host I/O. Exposed as a plain C ABI for ctypes.
//
// Build: make -C native        (produces libvptpu_native.so)

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <linux/videodev2.h>
#include <netinet/in.h>
#include <poll.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <ctime>
#include <unistd.h>

#include <new>

#include "h264_common.h"

extern "C" {

// ---------------------------------------------------------------------------
// V4L2 capture: mmap buffer ring, newest-frame semantics
// ---------------------------------------------------------------------------

struct V4l2Buffer {
    void* start;
    size_t length;
};

struct V4l2Camera {
    int fd;
    V4l2Buffer* buffers;
    uint32_t n_buffers;
    uint32_t width;
    uint32_t height;
    uint32_t pixelformat;
    uint32_t bytesperline;
};

static int xioctl(int fd, unsigned long request, void* arg) {
    int r;
    do {
        r = ioctl(fd, request, arg);
    } while (r == -1 && errno == EINTR);
    return r;
}

// Open a V4L2 device and start streaming. Returns NULL on failure.
// fourcc: 0 = device default; otherwise e.g. v4l2_fourcc('Y','U','Y','V').
V4l2Camera* vptpu_v4l2_open(const char* device, uint32_t width,
                            uint32_t height, uint32_t fourcc,
                            uint32_t n_buffers) {
    int fd = open(device, O_RDWR | O_NONBLOCK);
    if (fd < 0) return nullptr;

    v4l2_capability cap{};
    if (xioctl(fd, VIDIOC_QUERYCAP, &cap) < 0 ||
        !(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
        !(cap.capabilities & V4L2_CAP_STREAMING)) {
        close(fd);
        return nullptr;
    }

    v4l2_format fmt{};
    fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(fd, VIDIOC_G_FMT, &fmt);
    if (width) fmt.fmt.pix.width = width;
    if (height) fmt.fmt.pix.height = height;
    if (fourcc) fmt.fmt.pix.pixelformat = fourcc;
    fmt.fmt.pix.field = V4L2_FIELD_NONE;
    if (xioctl(fd, VIDIOC_S_FMT, &fmt) < 0) {
        close(fd);
        return nullptr;
    }

    if (n_buffers < 2) n_buffers = 4;
    v4l2_requestbuffers req{};
    req.count = n_buffers;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (xioctl(fd, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
        close(fd);
        return nullptr;
    }

    auto* cam = new (std::nothrow) V4l2Camera{};
    if (!cam) {
        close(fd);
        return nullptr;
    }
    cam->fd = fd;
    cam->n_buffers = req.count;
    cam->buffers = new (std::nothrow) V4l2Buffer[req.count]{};
    cam->width = fmt.fmt.pix.width;
    cam->height = fmt.fmt.pix.height;
    cam->pixelformat = fmt.fmt.pix.pixelformat;
    cam->bytesperline = fmt.fmt.pix.bytesperline;

    for (uint32_t i = 0; i < req.count; i++) {
        v4l2_buffer buf{};
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        buf.memory = V4L2_MEMORY_MMAP;
        buf.index = i;
        if (xioctl(fd, VIDIOC_QUERYBUF, &buf) < 0) goto fail;
        cam->buffers[i].length = buf.length;
        cam->buffers[i].start = mmap(nullptr, buf.length,
                                     PROT_READ | PROT_WRITE, MAP_SHARED, fd,
                                     buf.m.offset);
        if (cam->buffers[i].start == MAP_FAILED) goto fail;
        if (xioctl(fd, VIDIOC_QBUF, &buf) < 0) goto fail;
    }

    {
        v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        if (xioctl(fd, VIDIOC_STREAMON, &type) < 0) goto fail;
    }
    return cam;

fail:
    for (uint32_t i = 0; i < cam->n_buffers; i++) {
        if (cam->buffers[i].start && cam->buffers[i].start != MAP_FAILED)
            munmap(cam->buffers[i].start, cam->buffers[i].length);
    }
    delete[] cam->buffers;
    delete cam;
    close(fd);
    return nullptr;
}

uint32_t vptpu_v4l2_width(V4l2Camera* cam) { return cam->width; }
uint32_t vptpu_v4l2_height(V4l2Camera* cam) { return cam->height; }
uint32_t vptpu_v4l2_pixelformat(V4l2Camera* cam) { return cam->pixelformat; }
uint32_t vptpu_v4l2_bytesperline(V4l2Camera* cam) { return cam->bytesperline; }

// Grab the NEWEST available frame into `out` (size out_capacity). Older
// queued frames are dropped (the reference drivers run newest-only too).
// Returns bytes written, 0 on timeout, -1 on error.
// timestamp_us receives the kernel capture timestamp.
int64_t vptpu_v4l2_read(V4l2Camera* cam, uint8_t* out, int64_t out_capacity,
                        int timeout_ms, int64_t* timestamp_us) {
    pollfd pfd{cam->fd, POLLIN, 0};
    int pr = poll(&pfd, 1, timeout_ms);
    if (pr < 0) return -1;
    if (pr == 0) return 0;

    v4l2_buffer newest{};
    bool have = false;
    for (;;) {
        v4l2_buffer buf{};
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
        buf.memory = V4L2_MEMORY_MMAP;
        if (xioctl(cam->fd, VIDIOC_DQBUF, &buf) < 0) {
            if (errno == EAGAIN) break;
            return -1;
        }
        if (have) {
            // requeue the stale one
            xioctl(cam->fd, VIDIOC_QBUF, &newest);
        }
        newest = buf;
        have = true;
    }
    if (!have) return 0;

    int64_t n = newest.bytesused;
    if (n > out_capacity) n = out_capacity;
    memcpy(out, cam->buffers[newest.index].start, n);
    if (timestamp_us) {
        *timestamp_us = int64_t(newest.timestamp.tv_sec) * 1000000 +
                        newest.timestamp.tv_usec;
    }
    xioctl(cam->fd, VIDIOC_QBUF, &newest);
    return n;
}

void vptpu_v4l2_close(V4l2Camera* cam) {
    if (!cam) return;
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(cam->fd, VIDIOC_STREAMOFF, &type);
    for (uint32_t i = 0; i < cam->n_buffers; i++) {
        if (cam->buffers[i].start && cam->buffers[i].start != MAP_FAILED)
            munmap(cam->buffers[i].start, cam->buffers[i].length);
    }
    delete[] cam->buffers;
    close(cam->fd);
    delete cam;
}

// ---------------------------------------------------------------------------
// UDP multicast bus
// ---------------------------------------------------------------------------

struct McSocket {
    int fd;
    sockaddr_in target;
};

McSocket* vptpu_mc_open(const char* group, uint16_t port) {
    int fd = socket(AF_INET, SOCK_DGRAM, IPPROTO_UDP);
    if (fd < 0) return nullptr;

    int yes = 1;
    setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &yes, sizeof(yes));
    setsockopt(fd, SOL_SOCKET, SO_BROADCAST, &yes, sizeof(yes));
    int ttl = 32;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));

    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(port);
    if (inet_aton(group, &addr.sin_addr) == 0) {
        close(fd);
        return nullptr;
    }
    if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
        close(fd);
        return nullptr;
    }

    ip_mreq mreq{};
    inet_pton(AF_INET, group, &mreq.imr_multiaddr);
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));

    auto* sock = new (std::nothrow) McSocket{};
    if (!sock) {
        close(fd);
        return nullptr;
    }
    sock->fd = fd;
    sock->target = addr;
    return sock;
}

int64_t vptpu_mc_send(McSocket* sock, const uint8_t* data, int64_t len) {
    return sendto(sock->fd, data, len, 0,
                  reinterpret_cast<sockaddr*>(&sock->target),
                  sizeof(sock->target));
}

// Receive one datagram; returns length, 0 on timeout, -1 on error.
int64_t vptpu_mc_recv(McSocket* sock, uint8_t* out, int64_t capacity,
                      int timeout_ms) {
    pollfd pfd{sock->fd, POLLIN, 0};
    int pr = poll(&pfd, 1, timeout_ms);
    if (pr <= 0) return pr;
    ssize_t n = recv(sock->fd, out, capacity, 0);
    return n;
}

void vptpu_mc_close(McSocket* sock) {
    if (!sock) return;
    close(sock->fd);
    delete sock;
}

// ---------------------------------------------------------------------------
// Monotonic high-resolution clock (microseconds)
// ---------------------------------------------------------------------------

int64_t vptpu_monotonic_us() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return int64_t(ts.tv_sec) * 1000000 + ts.tv_nsec / 1000;
}

// ---------------------------------------------------------------------------
// In-process H.264 encoder: lossless all-intra I_PCM baseline
// ---------------------------------------------------------------------------
//
// The reference streams H.264 over RTP through libav with a hardware/x264
// encoder auto-pick (reference src/rtpstreamer.cpp:62-93). This environment
// ships no H.264 encoder at all, so the native layer provides one: every
// macroblock is coded I_PCM (raw samples, ITU-T H.264 7.3.5 / 7.4.5), which
// yields a fully standard baseline bitstream any decoder plays, losslessly,
// at negligible CPU cost. The tradeoff is bitrate (~12 bits/px) — fine for
// the LAN debug stream this feeds. Frame dimensions must be multiples of 16
// (the Python caller pads).

using vptpu::BitWriter;
using vptpu::emit_nal;

// Encode one I420 frame as annex-B [SPS][PPS][IDR slice], all-I_PCM.
// y: width*height, u/v: (width/2)*(height/2); width/height multiples of 16.
// scratch must hold >= width*height*3/2 + width*height/256*8 + 256 bytes;
// out should be ~scratch_size * 1.01. Returns bytes written or -1.
long vptpu_h264_ipcm_encode(const uint8_t* y, const uint8_t* u,
                            const uint8_t* v, int width, int height,
                            int idr_pic_id, uint8_t* scratch, long scratch_cap,
                            uint8_t* out, long out_cap) {
    if (width % 16 || height % 16) return -1;
    const int mbs_x = width / 16, mbs_y = height / 16;
    long off = vptpu::emit_sps_pps(out, out_cap, 0, scratch, scratch_cap,
                                   mbs_x, mbs_y);
    if (off < 0) return -1;
    // --- IDR slice, one per frame ---
    {
        BitWriter w{scratch, scratch_cap};
        w.put_ue(0);                      // first_mb_in_slice
        w.put_ue(7);                      // slice_type: I (all slices)
        w.put_ue(0);                      // pic_parameter_set_id
        w.put_bits(0, 4);                 // frame_num (IDR: 0)
        w.put_ue(uint32_t(idr_pic_id & 1));  // consecutive IDRs must differ
        w.put_bit(0);                     // no_output_of_prior_pics_flag
        w.put_bit(0);                     // long_term_reference_flag
        w.put_se(0);                      // slice_qp_delta
        w.put_ue(1);                      // disable_deblocking_filter_idc
        uint8_t mb[256 + 64 + 64];
        for (int my = 0; my < mbs_y; ++my) {
            for (int mx = 0; mx < mbs_x; ++mx) {
                w.put_ue(25);             // mb_type: I_PCM
                w.byte_align_zero();      // pcm_alignment_zero_bit(s)
                uint8_t* p = mb;
                const uint8_t* ysrc = y + (my * 16) * width + mx * 16;
                for (int r = 0; r < 16; ++r, ysrc += width, p += 16)
                    memcpy(p, ysrc, 16);
                const int cw = width / 2;
                const uint8_t* usrc = u + (my * 8) * cw + mx * 8;
                for (int r = 0; r < 8; ++r, usrc += cw, p += 8)
                    memcpy(p, usrc, 8);
                const uint8_t* vsrc = v + (my * 8) * cw + mx * 8;
                for (int r = 0; r < 8; ++r, vsrc += cw, p += 8)
                    memcpy(p, vsrc, 8);
                w.put_bytes(mb, sizeof(mb));
            }
        }
        w.rbsp_trailing();
        if (w.pos >= scratch_cap) return -1;
        off = emit_nal(out, out_cap, off, 3, 5, scratch, w.pos);
        if (off < 0) return -1;
    }
    return off;
}

}  // extern "C"
