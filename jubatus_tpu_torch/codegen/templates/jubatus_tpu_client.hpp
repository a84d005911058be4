// jubatus_tpu_client.hpp — self-contained C++ client runtime for the
// jubatus_tpu MessagePack-RPC plane.
//
// Equivalent of the reference's client stack (jubatus/client/common/client.hpp
// over jubatus_msgpack-rpc), redesigned as one dependency-free header: a
// minimal MessagePack codec, a blocking TCP RPC client, the datum type
// (client/common/datum.hpp), and the common client base with the built-ins
// get_config/save/load/get_status/do_mix/get_proxy_status
// (client/common/client.hpp:30-87). Generated <engine>_client.hpp headers
// (jubatus_tpu.codegen, --lang cpp) include this file.
//
// Requires C++11 and POSIX sockets. Wire protocol: msgpack-rpc
// [type, msgid, method, params] requests / [1, msgid, error, result]
// responses, identical to the reference servers and to jubatus_tpu's
// rpc/server.py, so this client talks to either. The parser accepts both
// old (pre-2.0 raw) and new (str/bin) msgpack encodings; the packer emits
// the new format by default — call rpc_client::set_legacy_format(true)
// when talking to a reference jubatus server (its vendored msgpack fork
// predates str8/bin and rejects those type bytes).
#ifndef JUBATUS_TPU_CLIENT_HPP_
#define JUBATUS_TPU_CLIENT_HPP_

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

namespace jubatus_tpu {

// ---------------------------------------------------------------- msgpack --
namespace mp {

struct value {
  enum kind_t { NIL, BOOLEAN, INT, UINT, FLOAT, STR, BIN, ARR, MAP };
  kind_t k;
  bool b;
  int64_t i;
  uint64_t u;
  double f;
  std::string s;                              // STR and BIN payloads
  std::vector<value> a;                       // ARR elements
  std::vector<std::pair<value, value> > m;    // MAP entries, wire order

  value() : k(NIL), b(false), i(0), u(0), f(0) {}

  bool is_nil() const { return k == NIL; }

  int64_t as_int() const {
    switch (k) {
      case INT: return i;
      case UINT: return static_cast<int64_t>(u);
      case FLOAT: return static_cast<int64_t>(f);
      case BOOLEAN: return b ? 1 : 0;
      default: throw std::runtime_error("msgpack: value is not an integer");
    }
  }
  uint64_t as_uint() const {
    switch (k) {
      case UINT: return u;
      case INT:
        if (i < 0) throw std::runtime_error("msgpack: negative as_uint");
        return static_cast<uint64_t>(i);
      case FLOAT: return static_cast<uint64_t>(f);
      case BOOLEAN: return b ? 1u : 0u;
      default: throw std::runtime_error("msgpack: value is not an integer");
    }
  }
  double as_double() const {
    switch (k) {
      case FLOAT: return f;
      case INT: return static_cast<double>(i);
      case UINT: return static_cast<double>(u);
      default: throw std::runtime_error("msgpack: value is not a number");
    }
  }
  bool as_bool() const {
    if (k == BOOLEAN) return b;
    return as_int() != 0;
  }
  // Lenient: status maps carry numbers the reference stringifies; do the same.
  std::string as_str() const {
    switch (k) {
      case STR: case BIN: return s;
      case INT: { std::ostringstream o; o << i; return o.str(); }
      case UINT: { std::ostringstream o; o << u; return o.str(); }
      case FLOAT: { std::ostringstream o; o << f; return o.str(); }
      case BOOLEAN: return b ? "true" : "false";
      case NIL: return "";
      default: throw std::runtime_error("msgpack: value is not a string");
    }
  }
  const std::vector<value>& as_arr() const {
    if (k != ARR) throw std::runtime_error("msgpack: value is not an array");
    return a;
  }
};

inline value v_nil() { return value(); }
inline value v_bool(bool x) { value v; v.k = value::BOOLEAN; v.b = x; return v; }
inline value v_int(int64_t x) { value v; v.k = value::INT; v.i = x; return v; }
inline value v_uint(uint64_t x) { value v; v.k = value::UINT; v.u = x; return v; }
inline value v_double(double x) { value v; v.k = value::FLOAT; v.f = x; return v; }
inline value v_str(const std::string& x) { value v; v.k = value::STR; v.s = x; return v; }
inline value v_bin(const std::string& x) { value v; v.k = value::BIN; v.s = x; return v; }
inline value v_arr() { value v; v.k = value::ARR; return v; }
inline value v_map() { value v; v.k = value::MAP; return v; }

// -- packing ---------------------------------------------------------------
inline void put_be(std::string& out, uint64_t x, int nbytes) {
  for (int s = (nbytes - 1) * 8; s >= 0; s -= 8)
    out.push_back(static_cast<char>((x >> s) & 0xff));
}

inline void pack_uint(std::string& out, uint64_t x) {
  if (x < 0x80) { out.push_back(static_cast<char>(x)); }
  else if (x <= 0xff) { out.push_back('\xcc'); put_be(out, x, 1); }
  else if (x <= 0xffff) { out.push_back('\xcd'); put_be(out, x, 2); }
  else if (x <= 0xffffffffULL) { out.push_back('\xce'); put_be(out, x, 4); }
  else { out.push_back('\xcf'); put_be(out, x, 8); }
}

inline void pack_int(std::string& out, int64_t x) {
  if (x >= 0) { pack_uint(out, static_cast<uint64_t>(x)); return; }
  if (x >= -32) { out.push_back(static_cast<char>(x)); }
  else if (x >= -128) { out.push_back('\xd0'); put_be(out, static_cast<uint8_t>(x), 1); }
  else if (x >= -32768) { out.push_back('\xd1'); put_be(out, static_cast<uint16_t>(x), 2); }
  else if (x >= -2147483648LL) { out.push_back('\xd2'); put_be(out, static_cast<uint32_t>(x), 4); }
  else { out.push_back('\xd3'); put_be(out, static_cast<uint64_t>(x), 8); }
}

// legacy=true emits pre-2.0 msgpack (fixraw/raw16/raw32 only; no str8, no
// bin family) for the reference's vendored msgpack fork.
inline void pack(std::string& out, const value& v, bool legacy = false) {
  switch (v.k) {
    case value::NIL: out.push_back('\xc0'); break;
    case value::BOOLEAN: out.push_back(v.b ? '\xc3' : '\xc2'); break;
    case value::INT: pack_int(out, v.i); break;
    case value::UINT: pack_uint(out, v.u); break;
    case value::FLOAT: {
      out.push_back('\xcb');
      uint64_t bits;
      std::memcpy(&bits, &v.f, 8);
      put_be(out, bits, 8);
      break;
    }
    case value::STR:
    case value::BIN: {
      size_t n = v.s.size();
      bool as_raw = legacy || v.k == value::STR;
      if (!as_raw) {  // new-format bin 8/16/32
        if (n <= 0xff) { out.push_back('\xc4'); put_be(out, n, 1); }
        else if (n <= 0xffff) { out.push_back('\xc5'); put_be(out, n, 2); }
        else { out.push_back('\xc6'); put_be(out, n, 4); }
      } else if (n < 32) {
        out.push_back(static_cast<char>(0xa0 | n));
      } else if (!legacy && n <= 0xff) {
        out.push_back('\xd9');  // str8: new format only
        put_be(out, n, 1);
      } else if (n <= 0xffff) {
        out.push_back('\xda');
        put_be(out, n, 2);
      } else {
        out.push_back('\xdb');
        put_be(out, n, 4);
      }
      out.append(v.s);
      break;
    }
    case value::ARR: {
      size_t n = v.a.size();
      if (n < 16) out.push_back(static_cast<char>(0x90 | n));
      else if (n <= 0xffff) { out.push_back('\xdc'); put_be(out, n, 2); }
      else { out.push_back('\xdd'); put_be(out, n, 4); }
      for (size_t j = 0; j < n; ++j) pack(out, v.a[j], legacy);
      break;
    }
    case value::MAP: {
      size_t n = v.m.size();
      if (n < 16) out.push_back(static_cast<char>(0x80 | n));
      else if (n <= 0xffff) { out.push_back('\xde'); put_be(out, n, 2); }
      else { out.push_back('\xdf'); put_be(out, n, 4); }
      for (size_t j = 0; j < n; ++j) {
        pack(out, v.m[j].first, legacy);
        pack(out, v.m[j].second, legacy);
      }
      break;
    }
  }
}

// -- parsing (incremental: returns false when the buffer is incomplete) ----
inline bool need(const std::string& buf, size_t pos, size_t n) {
  return buf.size() - pos >= n;
}

inline uint64_t get_be(const std::string& buf, size_t pos, int nbytes) {
  uint64_t x = 0;
  for (int j = 0; j < nbytes; ++j)
    x = (x << 8) | static_cast<uint8_t>(buf[pos + j]);
  return x;
}

inline bool parse(const std::string& buf, size_t& pos, value& out);

inline bool parse_seq(const std::string& buf, size_t& pos, value& out, size_t n,
                      bool is_map) {
  if (is_map) {
    out.k = value::MAP;
    out.m.reserve(n);
    for (size_t j = 0; j < n; ++j) {
      value k, v;
      if (!parse(buf, pos, k) || !parse(buf, pos, v)) return false;
      out.m.push_back(std::make_pair(k, v));
    }
  } else {
    out.k = value::ARR;
    out.a.reserve(n);
    for (size_t j = 0; j < n; ++j) {
      value v;
      if (!parse(buf, pos, v)) return false;
      out.a.push_back(v);
    }
  }
  return true;
}

inline bool parse(const std::string& buf, size_t& pos, value& out) {
  if (!need(buf, pos, 1)) return false;
  uint8_t c = static_cast<uint8_t>(buf[pos++]);
  if (c < 0x80) { out = v_uint(c); return true; }
  if (c >= 0xe0) { out = v_int(static_cast<int8_t>(c)); return true; }
  if (c >= 0xa0 && c < 0xc0) {  // fixstr
    size_t n = c & 0x1f;
    if (!need(buf, pos, n)) return false;
    out = v_str(buf.substr(pos, n));
    pos += n;
    return true;
  }
  if (c >= 0x90 && c < 0xa0) return parse_seq(buf, pos, out, c & 0x0f, false);
  if (c >= 0x80 && c < 0x90) return parse_seq(buf, pos, out, c & 0x0f, true);
  size_t n;
  switch (c) {
    case 0xc0: out = v_nil(); return true;
    case 0xc2: out = v_bool(false); return true;
    case 0xc3: out = v_bool(true); return true;
    case 0xcc: case 0xcd: case 0xce: case 0xcf: {
      int w = 1 << (c - 0xcc);
      if (!need(buf, pos, w)) return false;
      out = v_uint(get_be(buf, pos, w));
      pos += w;
      return true;
    }
    case 0xd0: case 0xd1: case 0xd2: case 0xd3: {
      int w = 1 << (c - 0xd0);
      if (!need(buf, pos, w)) return false;
      uint64_t raw = get_be(buf, pos, w);
      pos += w;
      int64_t x;
      switch (w) {
        case 1: x = static_cast<int8_t>(raw); break;
        case 2: x = static_cast<int16_t>(raw); break;
        case 4: x = static_cast<int32_t>(raw); break;
        default: x = static_cast<int64_t>(raw); break;
      }
      out = v_int(x);
      return true;
    }
    case 0xca: {
      if (!need(buf, pos, 4)) return false;
      uint32_t bits = static_cast<uint32_t>(get_be(buf, pos, 4));
      pos += 4;
      float x;
      std::memcpy(&x, &bits, 4);
      out = v_double(x);
      return true;
    }
    case 0xcb: {
      if (!need(buf, pos, 8)) return false;
      uint64_t bits = get_be(buf, pos, 8);
      pos += 8;
      double x;
      std::memcpy(&x, &bits, 8);
      out = v_double(x);
      return true;
    }
    case 0xd9: case 0xda: case 0xdb:        // str 8/16/32
    case 0xc4: case 0xc5: case 0xc6: {      // bin 8/16/32
      int w = (c >= 0xd9) ? (1 << (c - 0xd9)) : (1 << (c - 0xc4));
      if (!need(buf, pos, w)) return false;
      n = get_be(buf, pos, w);
      pos += w;
      if (!need(buf, pos, n)) return false;
      out = (c >= 0xd9) ? v_str(buf.substr(pos, n)) : v_bin(buf.substr(pos, n));
      pos += n;
      return true;
    }
    case 0xdc: case 0xdd: {                 // array 16/32
      int w = (c == 0xdc) ? 2 : 4;
      if (!need(buf, pos, w)) return false;
      n = get_be(buf, pos, w);
      pos += w;
      return parse_seq(buf, pos, out, n, false);
    }
    case 0xde: case 0xdf: {                 // map 16/32
      int w = (c == 0xde) ? 2 : 4;
      if (!need(buf, pos, w)) return false;
      n = get_be(buf, pos, w);
      pos += w;
      return parse_seq(buf, pos, out, n, true);
    }
    default:
      throw std::runtime_error("msgpack: unsupported type byte");
  }
}

// skip: completeness scan without building a value tree — linear, no
// allocations. Used by the client to cheaply test "is one full message
// buffered yet?" before paying for a real parse.
inline bool skip(const std::string& buf, size_t& pos) {
  if (!need(buf, pos, 1)) return false;
  uint8_t c = static_cast<uint8_t>(buf[pos++]);
  if (c < 0x80 || c >= 0xe0) return true;            // fixint
  if (c >= 0xa0 && c < 0xc0) {                       // fixstr
    size_t n = c & 0x1f;
    if (!need(buf, pos, n)) return false;
    pos += n;
    return true;
  }
  size_t count = 0, width = 0, payload = 0;
  bool is_map = false;
  if (c >= 0x90 && c < 0xa0) { count = c & 0x0f; }
  else if (c >= 0x80 && c < 0x90) { count = c & 0x0f; is_map = true; }
  else {
    switch (c) {
      case 0xc0: case 0xc2: case 0xc3: return true;
      case 0xcc: case 0xcd: case 0xce: case 0xcf: width = 1 << (c - 0xcc); break;
      case 0xd0: case 0xd1: case 0xd2: case 0xd3: width = 1 << (c - 0xd0); break;
      case 0xca: width = 4; break;
      case 0xcb: width = 8; break;
      case 0xd9: case 0xda: case 0xdb:
      case 0xc4: case 0xc5: case 0xc6: {
        int w = (c >= 0xd9) ? (1 << (c - 0xd9)) : (1 << (c - 0xc4));
        if (!need(buf, pos, w)) return false;
        payload = get_be(buf, pos, w);
        pos += w;
        if (!need(buf, pos, payload)) return false;
        pos += payload;
        return true;
      }
      case 0xdc: case 0xdd: case 0xde: case 0xdf: {
        int w = (c == 0xdc || c == 0xde) ? 2 : 4;
        if (!need(buf, pos, w)) return false;
        count = get_be(buf, pos, w);
        pos += w;
        is_map = (c >= 0xde);
        break;
      }
      default:
        throw std::runtime_error("msgpack: unsupported type byte");
    }
    if (width) {
      if (!need(buf, pos, width)) return false;
      pos += width;
      return true;
    }
  }
  size_t items = is_map ? count * 2 : count;
  for (size_t j = 0; j < items; ++j)
    if (!skip(buf, pos)) return false;
  return true;
}

}  // namespace mp

// -------------------------------------------------------------- rpc client --
class rpc_error : public std::runtime_error {
 public:
  explicit rpc_error(const std::string& what) : std::runtime_error(what) {}
};

class rpc_client {
 public:
  rpc_client(const std::string& host, int port, double timeout_sec = 10.0)
      : fd_(-1), msgid_(0), legacy_(false) {
    connect_(host, port, timeout_sec);
  }

  // pre-2.0 msgpack encodings for reference jubatus servers (their
  // vendored msgpack fork rejects str8/bin type bytes)
  void set_legacy_format(bool on) { legacy_ = on; }
  ~rpc_client() { close(); }

  void close() {
    if (fd_ >= 0) {
      ::close(fd_);
      fd_ = -1;
    }
  }

  mp::value call(const std::string& method, const std::vector<mp::value>& params) {
    uint64_t id = ++msgid_;
    mp::value req = mp::v_arr();
    req.a.push_back(mp::v_uint(0));
    req.a.push_back(mp::v_uint(id));
    req.a.push_back(mp::v_str(method));
    mp::value pv = mp::v_arr();
    pv.a = params;
    req.a.push_back(pv);
    std::string out;
    mp::pack(out, req, legacy_);
    send_all_(out);
    for (;;) {
      mp::value msg = read_message_();
      if (msg.k != mp::value::ARR || msg.a.size() != 4) continue;
      if (msg.a[0].as_uint() != 1 || msg.a[1].as_uint() != id) continue;
      if (!msg.a[2].is_nil()) throw rpc_error(method + ": " + describe_(msg.a[2]));
      return msg.a[3];
    }
  }

 private:
  void connect_(const std::string& host, int port, double timeout_sec) {
    struct addrinfo hints, *res = NULL;
    std::memset(&hints, 0, sizeof(hints));
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    std::ostringstream p;
    p << port;
    if (getaddrinfo(host.c_str(), p.str().c_str(), &hints, &res) != 0 || !res)
      throw rpc_error("cannot resolve " + host);
    fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd_ < 0) {
      freeaddrinfo(res);
      throw rpc_error("cannot create socket");
    }
    struct timeval tv;
    tv.tv_sec = static_cast<long>(timeout_sec);
    tv.tv_usec = static_cast<long>((timeout_sec - tv.tv_sec) * 1e6);
    setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd_, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    int one = 1;
    setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    int rc = ::connect(fd_, res->ai_addr, res->ai_addrlen);
    freeaddrinfo(res);
    if (rc != 0) {
      close();
      throw rpc_error("cannot connect to " + host + ":" + p.str());
    }
  }

  void send_all_(const std::string& data) {
    size_t sent = 0;
    while (sent < data.size()) {
      ssize_t n = ::send(fd_, data.data() + sent, data.size() - sent, 0);
      if (n <= 0) throw rpc_error("send failed (connection lost or timeout)");
      sent += static_cast<size_t>(n);
    }
  }

  mp::value read_message_() {
    for (;;) {
      // cheap no-alloc completeness scan first; build the tree only once
      size_t end = 0;
      if (!rbuf_.empty() && mp::skip(rbuf_, end)) {
        size_t pos = 0;
        mp::value out;
        mp::parse(rbuf_, pos, out);
        rbuf_.erase(0, pos);
        return out;
      }
      char chunk[65536];
      ssize_t n = ::recv(fd_, chunk, sizeof(chunk), 0);
      if (n <= 0) throw rpc_error("recv failed (connection lost or timeout)");
      rbuf_.append(chunk, static_cast<size_t>(n));
    }
  }

  static std::string describe_(const mp::value& err) {
    // msgpack-rpc integer codes (rpc/errors.py, mprpc convention)
    if (err.k == mp::value::INT || err.k == mp::value::UINT) {
      int64_t code = err.as_int();
      if (code == 1) return "method not found";
      if (code == 2) return "argument error";
      std::ostringstream o;
      o << "remote error code " << code;
      return o.str();
    }
    if (err.k == mp::value::STR) return err.s;
    std::string out;
    mp::pack(out, err);
    return "remote error (" + out + ")";
  }

  int fd_;
  uint64_t msgid_;
  bool legacy_;
  std::string rbuf_;
};

// -------------------------------------------------- typed conversion layer --
// conv<T>: T <-> mp::value. Generated headers add specializations for their
// IDL message structs; containers compose through the partial specializations.
template <class T>
struct conv;

template <>
struct conv<int64_t> {
  static mp::value to(int64_t x) { return mp::v_int(x); }
  static int64_t from(const mp::value& v) { return v.as_int(); }
};

template <>
struct conv<int32_t> {
  static mp::value to(int32_t x) { return mp::v_int(x); }
  static int32_t from(const mp::value& v) { return static_cast<int32_t>(v.as_int()); }
};

template <>
struct conv<uint64_t> {
  static mp::value to(uint64_t x) { return mp::v_uint(x); }
  static uint64_t from(const mp::value& v) { return v.as_uint(); }
};

template <>
struct conv<uint32_t> {
  static mp::value to(uint32_t x) { return mp::v_uint(x); }
  static uint32_t from(const mp::value& v) { return static_cast<uint32_t>(v.as_uint()); }
};

template <>
struct conv<double> {
  static mp::value to(double x) { return mp::v_double(x); }
  static double from(const mp::value& v) { return v.as_double(); }
};

template <>
struct conv<float> {
  static mp::value to(float x) { return mp::v_double(x); }
  static float from(const mp::value& v) { return static_cast<float>(v.as_double()); }
};

template <>
struct conv<bool> {
  static mp::value to(bool x) { return mp::v_bool(x); }
  static bool from(const mp::value& v) { return v.as_bool(); }
};

template <>
struct conv<std::string> {
  static mp::value to(const std::string& x) { return mp::v_str(x); }
  static std::string from(const mp::value& v) { return v.as_str(); }
};

template <class T>
struct conv<std::vector<T> > {
  static mp::value to(const std::vector<T>& xs) {
    mp::value v = mp::v_arr();
    v.a.reserve(xs.size());
    for (size_t j = 0; j < xs.size(); ++j) v.a.push_back(conv<T>::to(xs[j]));
    return v;
  }
  static std::vector<T> from(const mp::value& v) {
    const std::vector<mp::value>& a = v.as_arr();
    std::vector<T> out;
    out.reserve(a.size());
    for (size_t j = 0; j < a.size(); ++j) out.push_back(conv<T>::from(a[j]));
    return out;
  }
};

template <class K, class V>
struct conv<std::map<K, V> > {
  static mp::value to(const std::map<K, V>& xs) {
    mp::value v = mp::v_map();
    for (typename std::map<K, V>::const_iterator it = xs.begin(); it != xs.end(); ++it)
      v.m.push_back(std::make_pair(conv<K>::to(it->first), conv<V>::to(it->second)));
    return v;
  }
  static std::map<K, V> from(const mp::value& v) {
    if (v.k != mp::value::MAP) throw std::runtime_error("msgpack: value is not a map");
    std::map<K, V> out;
    for (size_t j = 0; j < v.m.size(); ++j)
      out[conv<K>::from(v.m[j].first)] = conv<V>::from(v.m[j].second);
    return out;
  }
};

template <class A, class B>
struct conv<std::pair<A, B> > {
  static mp::value to(const std::pair<A, B>& x) {
    mp::value v = mp::v_arr();
    v.a.push_back(conv<A>::to(x.first));
    v.a.push_back(conv<B>::to(x.second));
    return v;
  }
  static std::pair<A, B> from(const mp::value& v) {
    const std::vector<mp::value>& a = v.as_arr();
    return std::make_pair(conv<A>::from(a.at(0)), conv<B>::from(a.at(1)));
  }
};

// --------------------------------------------------------------- datum ----
// ≙ jubatus/client/common/datum.hpp: three kv lists, wire 3-tuple.
struct datum {
  std::vector<std::pair<std::string, std::string> > string_values;
  std::vector<std::pair<std::string, double> > num_values;
  std::vector<std::pair<std::string, std::string> > binary_values;

  datum& add_string(const std::string& key, const std::string& v) {
    string_values.push_back(std::make_pair(key, v));
    return *this;
  }
  datum& add_number(const std::string& key, double v) {
    num_values.push_back(std::make_pair(key, v));
    return *this;
  }
  datum& add_binary(const std::string& key, const std::string& v) {
    binary_values.push_back(std::make_pair(key, v));
    return *this;
  }
};

template <>
struct conv<datum> {
  static mp::value to(const datum& d) {
    mp::value v = mp::v_arr();
    v.a.push_back(conv<std::vector<std::pair<std::string, std::string> > >::to(d.string_values));
    v.a.push_back(conv<std::vector<std::pair<std::string, double> > >::to(d.num_values));
    mp::value bins = mp::v_arr();
    for (size_t j = 0; j < d.binary_values.size(); ++j) {
      mp::value kv = mp::v_arr();
      kv.a.push_back(mp::v_str(d.binary_values[j].first));
      kv.a.push_back(mp::v_bin(d.binary_values[j].second));
      bins.a.push_back(kv);
    }
    v.a.push_back(bins);
    return v;
  }
  static datum from(const mp::value& v) {
    const std::vector<mp::value>& a = v.as_arr();
    datum d;
    if (a.size() > 0)
      d.string_values = conv<std::vector<std::pair<std::string, std::string> > >::from(a[0]);
    if (a.size() > 1)
      d.num_values = conv<std::vector<std::pair<std::string, double> > >::from(a[1]);
    if (a.size() > 2)
      d.binary_values = conv<std::vector<std::pair<std::string, std::string> > >::from(a[2]);
    return d;
  }
};

// ---------------------------------------------------------- client base ----
// ≙ jubatus::client::common::client (client/common/client.hpp:30-87).
namespace client {
namespace common {

class client {
 public:
  client(const std::string& host, uint64_t port, const std::string& name,
         double timeout_sec)
      : c_(host, static_cast<int>(port), timeout_sec), name_(name) {}

  rpc_client& get_client() { return c_; }

  std::string get_config() {
    return conv<std::string>::from(call("get_config", args()));
  }
  std::map<std::string, std::string> save(const std::string& id) {
    std::vector<mp::value> p = args();
    p.push_back(mp::v_str(id));
    return conv<std::map<std::string, std::string> >::from(call("save", p));
  }
  bool load(const std::string& id) {
    std::vector<mp::value> p = args();
    p.push_back(mp::v_str(id));
    return conv<bool>::from(call("load", p));
  }
  std::map<std::string, std::map<std::string, std::string> > get_status() {
    return conv<std::map<std::string, std::map<std::string, std::string> > >::from(
        call("get_status", args()));
  }
  bool do_mix() { return conv<bool>::from(call("do_mix", args())); }
  std::map<std::string, std::map<std::string, std::string> > get_proxy_status() {
    return conv<std::map<std::string, std::map<std::string, std::string> > >::from(
        call("get_proxy_status", args()));
  }

  std::string get_name() const { return name_; }
  void set_name(const std::string& name) { name_ = name; }

 protected:
  std::vector<mp::value> args() {
    std::vector<mp::value> p;
    p.push_back(mp::v_str(name_));
    return p;
  }
  mp::value call(const std::string& method, const std::vector<mp::value>& params) {
    return c_.call(method, params);
  }

  rpc_client c_;
  std::string name_;
};

}  // namespace common
}  // namespace client

}  // namespace jubatus_tpu

#endif  // JUBATUS_TPU_CLIENT_HPP_
