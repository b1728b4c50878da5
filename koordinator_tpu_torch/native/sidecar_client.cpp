// Compiled-language sidecar client: a C++ consumer of the ScheduleBatch
// wire format, proving a non-Python host (the reference's Go event loop,
// SURVEY.md 5.8, after the runtime proxy's proto-service pattern) can pack
// a batch, call the scheduling sidecar over the real socket, and read
// bindings back. The port's copy of koordinator_tpu/native/
// sidecar_client.cpp; the wire is the same sidecar.proto.
//
// grpc++ is not assumed on the host, so this speaks the gRPC wire
// protocol directly: HTTP/2 cleartext (h2c) over a unix socket with
// hand-rolled framing — client preface, SETTINGS exchange, one HEADERS
// frame (HPACK literal-without-indexing, no huffman — always valid HPACK),
// DATA frames carrying the 5-byte gRPC length-prefixed protobuf message,
// flow-control bookkeeping, PING/SETTINGS acks, and trailer detection.
// Messages (de)serialize through protoc-generated C++ classes
// (sidecar.pb.cc), the same schema the Python server registered.
//
// Usage: koord_sidecar_client <uds-path> <request-file> <response-file>
//                             [timeout-seconds]
//   request-file: serialized ScheduleBatchRequest
//   response-file: receives the serialized ScheduleBatchResponse
// Exit 0 on success; nonzero with a stderr line on any failure.

#include <arpa/inet.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <string>
#include <vector>

#include "sidecar.pb.h"

namespace {

constexpr uint8_t kFrameData = 0x0;
constexpr uint8_t kFrameHeaders = 0x1;
constexpr uint8_t kFrameRstStream = 0x3;
constexpr uint8_t kFrameSettings = 0x4;
constexpr uint8_t kFramePing = 0x6;
constexpr uint8_t kFrameGoaway = 0x7;
constexpr uint8_t kFrameWindowUpdate = 0x8;
constexpr uint8_t kFlagAck = 0x1;
constexpr uint8_t kFlagEndStream = 0x1;
constexpr uint8_t kFlagEndHeaders = 0x4;

int die(const std::string& msg) {
  std::cerr << "koord_sidecar_client: " << msg << "\n";
  return 1;
}

bool send_all(int fd, const uint8_t* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::send(fd, buf, len, 0);
    if (n <= 0) return false;
    buf += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, uint8_t* buf, size_t len) {
  while (len > 0) {
    ssize_t n = ::recv(fd, buf, len, 0);
    if (n <= 0) return false;
    buf += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

void put_frame_header(std::vector<uint8_t>& out, uint32_t len, uint8_t type,
                      uint8_t flags, uint32_t stream) {
  out.push_back((len >> 16) & 0xff);
  out.push_back((len >> 8) & 0xff);
  out.push_back(len & 0xff);
  out.push_back(type);
  out.push_back(flags);
  out.push_back((stream >> 24) & 0x7f);
  out.push_back((stream >> 16) & 0xff);
  out.push_back((stream >> 8) & 0xff);
  out.push_back(stream & 0xff);
}

// HPACK: literal header field without indexing, new name, no huffman.
// Integer fits in the 7-bit prefix for every length used here (< 127).
void put_literal_header(std::vector<uint8_t>& out, const std::string& name,
                        const std::string& value) {
  out.push_back(0x00);
  out.push_back(static_cast<uint8_t>(name.size()));
  out.insert(out.end(), name.begin(), name.end());
  out.push_back(static_cast<uint8_t>(value.size()));
  out.insert(out.end(), value.begin(), value.end());
}

struct FrameHeader {
  uint32_t length;
  uint8_t type;
  uint8_t flags;
  uint32_t stream;
};

bool read_frame_header(int fd, FrameHeader* fh) {
  uint8_t b[9];
  if (!recv_all(fd, b, 9)) return false;
  fh->length = (uint32_t(b[0]) << 16) | (uint32_t(b[1]) << 8) | b[2];
  fh->type = b[3];
  fh->flags = b[4];
  fh->stream = (uint32_t(b[5] & 0x7f) << 24) | (uint32_t(b[6]) << 16) |
               (uint32_t(b[7]) << 8) | b[8];
  return true;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4)
    return die("usage: <uds-path> <request-file> <response-file> [timeout-s]");
  const char* sock_path = argv[1];
  long timeout_s = argc > 4 ? atol(argv[4]) : 120;

  std::ifstream req_in(argv[2], std::ios::binary);
  if (!req_in) return die(std::string("cannot read ") + argv[2]);
  std::string req_bytes((std::istreambuf_iterator<char>(req_in)),
                        std::istreambuf_iterator<char>());
  {  // validate the request parses as the schema we claim to speak
    koordinator::scheduler::v1::ScheduleBatchRequest req;
    if (!req.ParseFromString(req_bytes))
      return die("request file is not a valid ScheduleBatchRequest");
  }

  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return die("socket() failed");
  struct timeval tv = {timeout_s, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  struct sockaddr_un addr;
  std::memset(&addr, 0, sizeof(addr));
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, sock_path, sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)))
    return die(std::string("connect failed: ") + sock_path);

  // ---- connection preface + empty SETTINGS
  std::vector<uint8_t> out;
  const char* preface = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
  out.insert(out.end(), preface, preface + 24);
  put_frame_header(out, 0, kFrameSettings, 0, 0);

  // ---- HEADERS (stream 1): the gRPC unary-call pseudo + grpc headers
  std::vector<uint8_t> hpack;
  put_literal_header(hpack, ":method", "POST");
  put_literal_header(hpack, ":scheme", "http");
  put_literal_header(
      hpack, ":path",
      "/koordinator.scheduler.v1.BatchedScheduler/ScheduleBatch");
  put_literal_header(hpack, ":authority", "localhost");
  put_literal_header(hpack, "content-type", "application/grpc");
  put_literal_header(hpack, "te", "trailers");
  put_frame_header(out, hpack.size(), kFrameHeaders, kFlagEndHeaders, 1);
  out.insert(out.end(), hpack.begin(), hpack.end());
  if (!send_all(fd, out.data(), out.size()))
    return die("send of preface/headers failed");

  // ---- DATA: 5-byte gRPC prefix (uncompressed flag + BE32 length) + body
  std::string payload;
  payload.push_back('\0');
  uint32_t blen = htonl(static_cast<uint32_t>(req_bytes.size()));
  payload.append(reinterpret_cast<char*>(&blen), 4);
  payload += req_bytes;

  // flow-control state (RFC 7540 defaults; server SETTINGS may raise them)
  int64_t conn_window = 65535, stream_window = 65535;
  int64_t initial_window = 65535;  // last advertised INITIAL_WINDOW_SIZE
  uint32_t max_frame = 16384;
  std::string resp_data;
  bool stream_done = false, settings_acked_by_us = false;
  size_t sent = 0;

  auto pump_one_frame = [&]() -> int {  // 0 ok, <0 error, 1 stream done
    FrameHeader fh;
    if (!read_frame_header(fd, &fh)) return -1;
    std::vector<uint8_t> body(fh.length);
    if (fh.length && !recv_all(fd, body.data(), fh.length)) return -1;
    switch (fh.type) {
      case kFrameSettings:
        if (!(fh.flags & kFlagAck)) {
          for (size_t i = 0; i + 6 <= body.size(); i += 6) {
            uint16_t id = (uint16_t(body[i]) << 8) | body[i + 1];
            uint32_t v = (uint32_t(body[i + 2]) << 24) |
                         (uint32_t(body[i + 3]) << 16) |
                         (uint32_t(body[i + 4]) << 8) | body[i + 5];
            if (id == 4) {  // INITIAL_WINDOW_SIZE: delta vs the PREVIOUS
                            // advertised value (re-sent SETTINGS are legal)
              stream_window += int64_t(v) - initial_window;
              initial_window = int64_t(v);
            } else if (id == 5) {
              max_frame = v;
            }
          }
          std::vector<uint8_t> ack;
          put_frame_header(ack, 0, kFrameSettings, kFlagAck, 0);
          if (!send_all(fd, ack.data(), ack.size())) return -1;
          settings_acked_by_us = true;
        }
        return 0;
      case kFramePing:
        if (!(fh.flags & kFlagAck)) {
          std::vector<uint8_t> ack;
          put_frame_header(ack, 8, kFramePing, kFlagAck, 0);
          ack.insert(ack.end(), body.begin(), body.end());
          if (!send_all(fd, ack.data(), ack.size())) return -1;
        }
        return 0;
      case kFrameWindowUpdate: {
        if (body.size() != 4) return -1;
        uint32_t inc = (uint32_t(body[0] & 0x7f) << 24) |
                       (uint32_t(body[1]) << 16) | (uint32_t(body[2]) << 8) |
                       body[3];
        if (fh.stream == 0)
          conn_window += inc;
        else if (fh.stream == 1)
          stream_window += inc;
        return 0;
      }
      case kFrameData: {
        if (fh.stream == 1) {
          resp_data.append(reinterpret_cast<char*>(body.data()), body.size());
          // replenish receive windows so large responses never stall
          if (fh.length) {
            std::vector<uint8_t> wu;
            for (uint32_t sid : {0u, 1u}) {
              put_frame_header(wu, 4, kFrameWindowUpdate, 0, sid);
              wu.push_back((fh.length >> 24) & 0x7f);
              wu.push_back((fh.length >> 16) & 0xff);
              wu.push_back((fh.length >> 8) & 0xff);
              wu.push_back(fh.length & 0xff);
            }
            if (!send_all(fd, wu.data(), wu.size())) return -1;
          }
          if (fh.flags & kFlagEndStream) return 1;
        }
        return 0;
      }
      case kFrameHeaders:  // response headers or trailers (HPACK skipped:
                           // success is judged by the protobuf payload)
        if (fh.stream == 1 && (fh.flags & kFlagEndStream)) return 1;
        return 0;
      case kFrameRstStream:
        return die("server reset the stream"), -1;
      case kFrameGoaway:
        return die("server sent GOAWAY"), -1;
      default:
        return 0;  // ignore PRIORITY, PUSH_PROMISE etc.
    }
  };

  while (sent < payload.size()) {
    int64_t can = std::min(conn_window, stream_window);
    if (can <= 0) {  // exhausted: service frames until a WINDOW_UPDATE
      int r = pump_one_frame();
      if (r < 0) return 1;
      if (r == 1) { stream_done = true; break; }
      continue;
    }
    size_t chunk = std::min(payload.size() - sent,
                            std::min(size_t(can), size_t(max_frame)));
    bool last = sent + chunk == payload.size();
    std::vector<uint8_t> data;
    put_frame_header(data, chunk, kFrameData, last ? kFlagEndStream : 0, 1);
    data.insert(data.end(), payload.begin() + sent,
                payload.begin() + sent + chunk);
    if (!send_all(fd, data.data(), data.size())) return die("DATA send failed");
    sent += chunk;
    conn_window -= chunk;
    stream_window -= chunk;
  }

  while (!stream_done) {
    int r = pump_one_frame();
    if (r < 0) return die("connection failed mid-response");
    if (r == 1) stream_done = true;
  }
  (void)settings_acked_by_us;
  ::close(fd);

  if (resp_data.size() < 5) return die("no gRPC message in response");
  if (resp_data[0] != 0) return die("compressed response unsupported");
  uint32_t mlen;
  std::memcpy(&mlen, resp_data.data() + 1, 4);
  mlen = ntohl(mlen);
  if (resp_data.size() < 5 + mlen) return die("truncated gRPC message");
  std::string msg = resp_data.substr(5, mlen);

  koordinator::scheduler::v1::ScheduleBatchResponse resp;
  if (!resp.ParseFromString(msg))
    return die("response is not a valid ScheduleBatchResponse");
  std::ofstream out_f(argv[3], std::ios::binary);
  out_f.write(msg.data(), msg.size());
  if (!out_f) return die(std::string("cannot write ") + argv[3]);
  std::cerr << "koord_sidecar_client: ok, chosen tensor "
            << resp.chosen().data().size() << " bytes, kernel "
            << resp.kernel_seconds() << "s\n";
  return 0;
}
