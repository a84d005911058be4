"""Ruby / Java / Go client emitters (≙ jenerator's ruby.ml/java.ml/go.ml).

codestyle: allow-tabs (the Go template below is tab-indented, as gofmt requires)

The reference generates client libraries for five languages from the same
IDL (tools/jenerator/src/{cpp,python,ruby,java,go}.ml); here C++ and Python
have first-class runtimes (emit_cpp.py, emit.py) and these three emit
idiomatic sources over each ecosystem's standard msgpack stack:

- Ruby: ``msgpack`` gem + TCPSocket, one generated file per service plus a
  shared ``jubatus_common.rb`` runtime (self-contained, like the C++ one).
- Java: POJOs + client over ``org.msgpack`` (the stack the reference's
  generated Java clients use).
- Go: typed structs with ``msgpack:",as_array"`` tags over
  ``github.com/vmihailenco/msgpack`` + a shared ``client.go`` runtime.

Wire behavior is identical across languages: [0, msgid, method,
[name, args...]] requests, message structs packed as field arrays in IDL
index order.
"""

from __future__ import annotations

from typing import Dict, List

from jubatus_tpu_torch.codegen.parser import (
    IdlFile,
    Message,
    Service,
    split_top_commas as _split_top,
)



def _camel(name: str) -> str:
    return "".join(p.title() for p in name.split("_"))


# --------------------------------------------------------------------- Ruby

RUBY_COMMON = '''# jubatus_common.rb — shared client runtime for generated jubatus_tpu
# Ruby clients (≙ the jubatus ruby client gem's common base). Wire protocol:
# msgpack-rpc [0, msgid, method, [name, args...]]; message structs travel as
# field arrays in IDL index order.
require "msgpack"
require "socket"

module JubatusTpu
  module Common
    class RpcError < StandardError; end

    class ClientBase
      def initialize(host, port, name, timeout = 10)
        @host, @port, @name, @timeout = host, port, name, timeout
        @msgid = 0
        @sock = Socket.tcp(host, port, connect_timeout: timeout)
        @sock.setsockopt(Socket::IPPROTO_TCP, Socket::TCP_NODELAY, 1)
        @unpacker = MessagePack::Unpacker.new
      end

      def close
        @sock&.close
        @sock = nil
      end

      attr_accessor :name

      # -- built-ins (client/common/client.hpp:30-87) ---------------------
      def get_config = call("get_config")
      def save(id) = call("save", id)
      def load(id) = call("load", id)
      def get_status = call("get_status")
      def do_mix = call("do_mix")
      def get_proxy_status = call("get_proxy_status")

      def call(method, *args)
        @msgid += 1
        wire = [0, @msgid, method.to_s, [@name, *args.map { |a| wireify(a) }]]
        @sock.write(wire.to_msgpack)
        loop do
          @unpacker.feed_each(read_chunk) do |msg|
            next unless msg.is_a?(Array) && msg.length == 4 &&
                        msg[0] == 1 && msg[1] == @msgid
            raise RpcError, describe_error(msg[2]) unless msg[2].nil?
            return msg[3]
          end
        end
      end

      private

      def read_chunk
        data = @sock.wait_readable(@timeout) ? @sock.readpartial(65_536) : nil
        raise RpcError, "timeout waiting for response" if data.nil?
        data
      end

      def describe_error(err)
        return "method not found" if err == 1
        return "argument error" if err == 2
        err.to_s
      end

      # structs (and nested containers of structs) → wire arrays
      def wireify(x)
        case x
        when Struct then x.to_a.map { |e| wireify(e) }
        when Array then x.map { |e| wireify(e) }
        when Hash then x.transform_values { |v| wireify(v) }
        else x
        end
      end
    end

    Datum = Struct.new(:string_values, :num_values, :binary_values) do
      def self.make(h = {})
        d = new([], [], [])
        h.each { |k, v| v.is_a?(String) ? d.string_values << [k.to_s, v] : d.num_values << [k.to_s, v.to_f] }
        d
      end

      def self.from_wire(a)
        new(a[0] || [], a[1] || [], a[2] || [])
      end
    end
  end
end
'''


def _ruby_cast(idl_type: str, expr: str, messages: set) -> str:
    """Wire value → typed value expression (Ruby)."""
    t = idl_type.strip()
    if t == "datum":
        return f"JubatusTpu::Common::Datum.from_wire({expr})"
    if t in messages:
        return f"{_camel(t)}.from_wire({expr})"
    if t.startswith("list<"):
        inner = t[5:-1].strip()
        sub = _ruby_cast(inner, "e", messages)
        return expr if sub == "e" else f"{expr}.map {{ |e| {sub} }}"
    if t.startswith("map<"):
        k, v = _split_top(t[4:-1])
        sub = _ruby_cast(v, "v", messages)
        return expr if sub == "v" else \
            f"{expr}.transform_values {{ |v| {sub} }}"
    if t.startswith("tuple<"):
        parts = _split_top(t[6:-1])
        casts = [_ruby_cast(p, f"{expr}[{j}]", messages)
                 for j, p in enumerate(parts)]
        return f"[{', '.join(casts)}]"
    return expr  # primitive


def emit_ruby_client(idl: IdlFile, service_name: str) -> Dict[str, str]:
    messages = {m.name for m in idl.messages}
    mod = _camel(service_name)
    out = [
        f"# {service_name}_client.rb — generated from {service_name}.idl by",
        "# jubatus_tpu.codegen (--lang ruby). *** DO NOT EDIT ***",
        'require_relative "jubatus_common"',
        "",
        "module JubatusTpu",
        f"  module {mod}",
    ]
    for msg in idl.messages:
        fields = sorted(msg.fields, key=lambda f: f.index)
        names = ", ".join(f":{f.name}" for f in fields)
        out.append(f"    {_camel(msg.name)} = Struct.new({names}) do")
        casts = [
            _ruby_cast(f.type, f"a[{j}]", messages) for j, f in enumerate(fields)
        ]
        out.append(f"      def self.from_wire(a)")
        out.append(f"        new({', '.join(casts)})")
        out.append("      end")
        out.append("    end")
        out.append("")
    out.append("    class Client < JubatusTpu::Common::ClientBase")
    svc: Service = idl.service(service_name)
    for d in svc.methods:
        args = ", ".join(a.name for a in d.args)
        callargs = "".join(f", {a.name}" for a in d.args)
        routing = d.routing + (f"({d.cht_n})" if d.routing == "cht" else "")
        out.append(f"      # #{routing} #{d.lock} #{d.aggregator} "
                   f"-> {d.return_type}")
        out.append(f"      def {d.name}({args})")
        cast = _ruby_cast(d.return_type, "res", messages)
        if cast == "res":
            out.append(f'        call("{d.name}"{callargs})')
        else:
            out.append(f'        res = call("{d.name}"{callargs})')
            out.append(f"        {cast}")
        out.append("      end")
        out.append("")
    out += ["    end", "  end", "end", ""]
    return {
        f"{service_name}_client.rb": "\n".join(out),
        "jubatus_common.rb": RUBY_COMMON,
    }


# --------------------------------------------------------------------- Java

_JAVA_PRIM = {
    "string": "String", "bool": "boolean", "double": "double",
    "float": "float", "int": "int", "long": "long", "short": "short",
    "byte": "byte", "uint": "long", "ulong": "long", "ushort": "int",
    "raw": "byte[]", "datum": "Datum", "void": "void",
}
_JAVA_BOX = {"boolean": "Boolean", "double": "Double", "float": "Float",
             "int": "Integer", "long": "Long", "short": "Short",
             "byte": "Byte"}


def _java_type(t: str, boxed: bool = False) -> str:
    t = t.strip()
    if t in _JAVA_PRIM:
        j = _JAVA_PRIM[t]
        return _JAVA_BOX.get(j, j) if boxed else j
    if t.startswith("list<"):
        return f"List<{_java_type(t[5:-1], True)}>"
    if t.startswith("map<"):
        k, v = _split_top(t[4:-1])
        return f"Map<{_java_type(k, True)}, {_java_type(v, True)}>"
    if t.startswith("tuple<"):
        a, b = _split_top(t[6:-1])
        return f"Tuple<{_java_type(a, True)}, {_java_type(b, True)}>"
    return _camel(t)


JAVA_CLIENT_BASE = '''// ClientBase.java — shared base for generated jubatus_tpu Java clients
// (≙ the jubatus java client's common base over org.msgpack.rpc). Results
// decode through explicit msgpack Templates — reflection on erased
// List.class/Map.class cannot recover element types, which is why the
// reference's jenerator emits template expressions too.
package us.jubatus_tpu.common;

import java.io.IOException;
import java.util.Map;
import org.msgpack.MessagePack;
import org.msgpack.rpc.Client;
import org.msgpack.rpc.loop.EventLoop;
import org.msgpack.template.Template;
import org.msgpack.template.Templates;
import org.msgpack.type.Value;
import org.msgpack.unpacker.Converter;

public class ClientBase {
  protected final Client c;
  protected String name;
  protected final MessagePack msgpack = new MessagePack();

  private static final Template<Map<String, String>> T_STR_MAP =
      Templates.tMap(Templates.TString, Templates.TString);
  private static final Template<Map<String, Map<String, String>>> T_STATUS =
      Templates.tMap(Templates.TString,
          Templates.tMap(Templates.TString, Templates.TString));

  public ClientBase(String host, int port, String name, double timeoutSec)
      throws Exception {
    EventLoop loop = EventLoop.defaultEventLoop();
    this.c = new Client(host, port, loop);
    this.c.setRequestTimeout((int) timeoutSec);
    this.name = name;
  }

  public void close() { c.close(); }
  public String getName() { return name; }
  public void setName(String name) { this.name = name; }

  protected Value call(String method, Object... args) {
    Object[] full = new Object[args.length + 1];
    full[0] = name;
    System.arraycopy(args, 0, full, 1, args.length);
    return c.callApply(method, full);
  }

  protected <T> T callTyped(Template<T> template, String method,
      Object... args) {
    try {
      return new Converter(msgpack, call(method, args)).read(template);
    } catch (IOException e) {
      throw new RuntimeException(e);
    }
  }

  @SuppressWarnings("unchecked")
  protected <T> Template<T> lookup(Class<T> type) {
    return (Template<T>) msgpack.lookup(type);
  }

  // built-ins (client/common/client.hpp:30-87)
  public String getConfig() {
    return callTyped(Templates.TString, "get_config");
  }
  public Map<String, String> save(String id) {
    return callTyped(T_STR_MAP, "save", id);
  }
  public boolean load(String id) {
    return callTyped(Templates.TBoolean, "load", id);
  }
  public Map<String, Map<String, String>> getStatus() {
    return callTyped(T_STATUS, "get_status");
  }
  public boolean doMix() {
    return callTyped(Templates.TBoolean, "do_mix");
  }
  public Map<String, Map<String, String>> getProxyStatus() {
    return callTyped(T_STATUS, "get_proxy_status");
  }
}
'''

JAVA_TUPLE_TEMPLATE = '''// TupleTemplate.java — msgpack Template for IDL tuple<A, B> (wire 2-array).
package us.jubatus_tpu.common;

import java.io.IOException;
import org.msgpack.packer.Packer;
import org.msgpack.template.AbstractTemplate;
import org.msgpack.template.Template;
import org.msgpack.unpacker.Unpacker;

public class TupleTemplate<A, B> extends AbstractTemplate<Tuple<A, B>> {
  private final Template<A> ta;
  private final Template<B> tb;

  public TupleTemplate(Template<A> ta, Template<B> tb) {
    this.ta = ta;
    this.tb = tb;
  }

  public void write(Packer pk, Tuple<A, B> v, boolean required)
      throws IOException {
    pk.writeArrayBegin(2);
    ta.write(pk, v.first);
    tb.write(pk, v.second);
    pk.writeArrayEnd();
  }

  public Tuple<A, B> read(Unpacker u, Tuple<A, B> to, boolean required)
      throws IOException {
    u.readArrayBegin();
    Tuple<A, B> out = new Tuple<A, B>(ta.read(u, null, true),
                                      tb.read(u, null, true));
    u.readArrayEnd();
    return out;
  }
}
'''

JAVA_DATUM = '''// Datum.java — client/common/datum.hpp mirror (wire 3-tuple).
package us.jubatus_tpu.common;

import java.util.ArrayList;
import java.util.List;
import org.msgpack.annotation.Message;

@Message
public class Datum {
  public List<Tuple<String, String>> stringValues = new ArrayList<Tuple<String, String>>();
  public List<Tuple<String, Double>> numValues = new ArrayList<Tuple<String, Double>>();
  public List<Tuple<String, byte[]>> binaryValues = new ArrayList<Tuple<String, byte[]>>();

  public Datum addString(String key, String value) {
    stringValues.add(new Tuple<String, String>(key, value));
    return this;
  }
  public Datum addNumber(String key, double value) {
    numValues.add(new Tuple<String, Double>(key, value));
    return this;
  }
  public Datum addBinary(String key, byte[] value) {
    binaryValues.add(new Tuple<String, byte[]>(key, value));
    return this;
  }
}
'''

JAVA_TUPLE = '''// Tuple.java — IDL tuple<A, B> (wire 2-array).
package us.jubatus_tpu.common;

import org.msgpack.annotation.Message;

@Message
public class Tuple<A, B> {
  public A first;
  public B second;

  public Tuple() {}
  public Tuple(A first, B second) {
    this.first = first;
    this.second = second;
  }
}
'''


def _java_lower_camel(name: str) -> str:
    c = _camel(name)
    return c[0].lower() + c[1:]


_JAVA_TEMPLATE_PRIM = {
    "string": "Templates.TString", "bool": "Templates.TBoolean",
    "double": "Templates.TDouble", "float": "Templates.TFloat",
    "int": "Templates.TInteger", "long": "Templates.TLong",
    "short": "Templates.TShort", "byte": "Templates.TByte",
    "uint": "Templates.TLong", "ulong": "Templates.TLong",
    "ushort": "Templates.TInteger", "raw": "Templates.TByteArray",
    "datum": "lookup(Datum.class)",
}


def _java_template(t: str) -> str:
    """IDL type → msgpack Template expression (recovers full element types;
    ≙ the template expressions jenerator emits)."""
    t = t.strip()
    if t in _JAVA_TEMPLATE_PRIM:
        return _JAVA_TEMPLATE_PRIM[t]
    if t.startswith("list<"):
        return f"Templates.tList({_java_template(t[5:-1])})"
    if t.startswith("map<"):
        k, v = _split_top(t[4:-1])
        return f"Templates.tMap({_java_template(k)}, {_java_template(v)})"
    if t.startswith("tuple<"):
        a, b = _split_top(t[6:-1])
        return (f"new TupleTemplate<{_java_type(a, True)}, {_java_type(b, True)}>"
                f"({_java_template(a)}, {_java_template(b)})")
    return f"lookup({_camel(t)}.class)"  # @Message POJO


def _emit_java_message(msg: Message, service_name: str) -> str:
    """One public @Message POJO per file (Java allows a single public
    top-level class per file — inline package-private classes would make
    the client API uncallable from user packages)."""
    name = _camel(msg.name)
    out = [
        f"// {name}.java — generated from {service_name}.idl by",
        "// jubatus_tpu.codegen (--lang java). *** DO NOT EDIT ***",
        f"package us.jubatus_tpu.{service_name};",
        "",
        "import java.util.List;",
        "import java.util.Map;",
        "import org.msgpack.annotation.Message;",
        "import us.jubatus_tpu.common.Datum;",
        "import us.jubatus_tpu.common.Tuple;",
        "",
        "@Message",
        f"public class {name} {{",
    ]
    for f in sorted(msg.fields, key=lambda f: f.index):
        out.append(f"  public {_java_type(f.type)} {_java_lower_camel(f.name)};")
    out += ["}", ""]
    return "\n".join(out)


def emit_java_client(idl: IdlFile, service_name: str) -> Dict[str, str]:
    cls = f"{_camel(service_name)}Client"
    out = [
        f"// {cls}.java — generated from {service_name}.idl by",
        "// jubatus_tpu.codegen (--lang java). *** DO NOT EDIT ***",
        "//",
        "// Runs over org.msgpack (the stack the reference's generated Java",
        "// clients use); message classes are @Message POJOs packed as field",
        "// arrays in IDL index order, one public class per file.",
        f"package us.jubatus_tpu.{service_name};",
        "",
        "import java.util.List;",
        "import java.util.Map;",
        "import org.msgpack.template.Templates;",
        "import us.jubatus_tpu.common.ClientBase;",
        "import us.jubatus_tpu.common.Datum;",
        "import us.jubatus_tpu.common.Tuple;",
        "import us.jubatus_tpu.common.TupleTemplate;",
        "",
    ]
    out.append(f"public class {cls} extends ClientBase {{")
    out.append(f"  public {cls}(String host, int port, String name, "
               "double timeoutSec) throws Exception {")
    out.append("    super(host, port, name, timeoutSec);")
    out.append("  }")
    out.append("")
    svc = idl.service(service_name)
    for d in svc.methods:
        ret = _java_type(d.return_type)
        params = ", ".join(
            f"{_java_type(a.type)} {_java_lower_camel(a.name)}" for a in d.args)
        callargs = "".join(f", {_java_lower_camel(a.name)}" for a in d.args)
        routing = d.routing + (f"({d.cht_n})" if d.routing == "cht" else "")
        out.append(f"  // #{routing} #{d.lock} #{d.aggregator}")
        if ret == "void":
            out.append(f"  public void {_java_lower_camel(d.name)}({params}) {{")
            out.append(f'    call("{d.name}"{callargs});')
        else:
            out.append(f"  public {ret} {_java_lower_camel(d.name)}({params}) {{")
            out.append(f"    return callTyped({_java_template(d.return_type)}, "
                       f'"{d.name}"{callargs});')
        out.append("  }")
        out.append("")
    out += ["}", ""]
    files = {
        f"{cls}.java": "\n".join(out),
        "ClientBase.java": JAVA_CLIENT_BASE,
        "Datum.java": JAVA_DATUM,
        "Tuple.java": JAVA_TUPLE,
        "TupleTemplate.java": JAVA_TUPLE_TEMPLATE,
    }
    reserved = set(files)
    for msg in idl.messages:
        fn = f"{_camel(msg.name)}.java"
        if fn in files:  # would silently clobber an earlier file
            what = ("reserved file (client class, ClientBase, Datum, Tuple, "
                    "or TupleTemplate)" if fn in reserved
                    else "another message that camel-cases to the same name")
            raise ValueError(
                f"message name {msg.name!r} collides with {what} at {fn} — "
                "rename the message for the Java backend")
        files[fn] = _emit_java_message(msg, service_name)
    return files


# ----------------------------------------------------------------------- Go

GO_COMMON = '''// client.go — shared runtime for generated jubatus_tpu Go clients.
// Wire protocol: msgpack-rpc [0, msgid, method, [name, args...]]; message
// structs use `msgpack:",as_array"` so they pack as field arrays in IDL
// index order (the reference's MSGPACK_DEFINE layout).
package jubatus_tpu

import (
	"fmt"
	"net"
	"time"

	"github.com/vmihailenco/msgpack/v5"
)

type RPCError struct{ Message string }

func (e *RPCError) Error() string { return e.Message }

type ClientBase struct {
	Name    string
	conn    net.Conn
	dec     *msgpack.Decoder
	timeout time.Duration
	msgid   uint64
}

func NewClientBase(host string, port int, name string, timeout time.Duration) (*ClientBase, error) {
	conn, err := net.DialTimeout("tcp", fmt.Sprintf("%s:%d", host, port), timeout)
	if err != nil {
		return nil, err
	}
	return &ClientBase{Name: name, conn: conn, dec: msgpack.NewDecoder(conn), timeout: timeout}, nil
}

func (c *ClientBase) Close() error { return c.conn.Close() }

type response struct {
	_msgpack struct{}           `msgpack:",as_array"`
	Type     int                `msgpack:"type"`
	Msgid    uint64             `msgpack:"msgid"`
	Error    msgpack.RawMessage `msgpack:"error"`
	Result   msgpack.RawMessage `msgpack:"result"`
}

// Call fires one msgpack-rpc request; args must NOT include the cluster
// name (it is prepended here), out receives the decoded result.
func (c *ClientBase) Call(method string, args []interface{}, out interface{}) error {
	c.msgid++
	params := append([]interface{}{c.Name}, args...)
	req := []interface{}{0, c.msgid, method, params}
	payload, err := msgpack.Marshal(req)
	if err != nil {
		return err
	}
	if err := c.conn.SetDeadline(time.Now().Add(c.timeout)); err != nil {
		return err
	}
	if _, err := c.conn.Write(payload); err != nil {
		return err
	}
	for {
		var resp response
		if err := c.dec.Decode(&resp); err != nil {
			return err
		}
		if resp.Type != 1 || resp.Msgid != c.msgid {
			continue
		}
		var errField interface{}
		_ = msgpack.Unmarshal(resp.Error, &errField)
		if errField != nil {
			return &RPCError{Message: describeError(errField)}
		}
		if out == nil {
			return nil
		}
		return msgpack.Unmarshal(resp.Result, out)
	}
}

func describeError(e interface{}) string {
	switch v := e.(type) {
	case int8, int16, int32, int64, uint8, uint16, uint32, uint64, int:
		if fmt.Sprintf("%v", v) == "1" {
			return "method not found"
		}
		if fmt.Sprintf("%v", v) == "2" {
			return "argument error"
		}
	}
	return fmt.Sprintf("%v", e)
}

// Built-ins (client/common/client.hpp:30-87).
func (c *ClientBase) GetConfig() (string, error) {
	var s string
	err := c.Call("get_config", nil, &s)
	return s, err
}

func (c *ClientBase) Save(id string) (map[string]string, error) {
	var m map[string]string
	err := c.Call("save", []interface{}{id}, &m)
	return m, err
}

func (c *ClientBase) Load(id string) (bool, error) {
	var b bool
	err := c.Call("load", []interface{}{id}, &b)
	return b, err
}

func (c *ClientBase) GetStatus() (map[string]map[string]interface{}, error) {
	var m map[string]map[string]interface{}
	err := c.Call("get_status", nil, &m)
	return m, err
}

func (c *ClientBase) DoMix() (bool, error) {
	var b bool
	err := c.Call("do_mix", nil, &b)
	return b, err
}

func (c *ClientBase) GetProxyStatus() (map[string]map[string]interface{}, error) {
	var m map[string]map[string]interface{}
	err := c.Call("get_proxy_status", nil, &m)
	return m, err
}

// Datum mirrors client/common/datum.hpp: three kv lists, wire 3-tuple.
type Datum struct {
	_msgpack     struct{}        `msgpack:",as_array"`
	StringValues [][2]interface{} `msgpack:"string_values"`
	NumValues    [][2]interface{} `msgpack:"num_values"`
	BinaryValues [][2]interface{} `msgpack:"binary_values"`
}

func NewDatum() *Datum {
	return &Datum{StringValues: [][2]interface{}{}, NumValues: [][2]interface{}{},
		BinaryValues: [][2]interface{}{}}
}

func (d *Datum) AddString(key, value string) *Datum {
	d.StringValues = append(d.StringValues, [2]interface{}{key, value})
	return d
}

func (d *Datum) AddNumber(key string, value float64) *Datum {
	d.NumValues = append(d.NumValues, [2]interface{}{key, value})
	return d
}
'''

_GO_PRIM = {
    "string": "string", "bool": "bool", "double": "float64",
    "float": "float32", "int": "int64", "long": "int64", "short": "int64",
    "byte": "int64", "uint": "uint64", "ulong": "uint64", "ushort": "uint64",
    "raw": "[]byte", "datum": "Datum",
}


def _go_type(t: str) -> str:
    t = t.strip()
    if t in _GO_PRIM:
        return _GO_PRIM[t]
    if t.startswith("list<"):
        return f"[]{_go_type(t[5:-1])}"
    if t.startswith("map<"):
        k, v = _split_top(t[4:-1])
        return f"map[{_go_type(k)}]{_go_type(v)}"
    if t.startswith("tuple<"):
        a, b = _split_top(t[6:-1])
        return f"[]interface{{}} /* tuple<{a}, {b}> */"
    return _camel(t)


def emit_go_client(idl: IdlFile, service_name: str) -> Dict[str, str]:
    cls = f"{_camel(service_name)}Client"
    out = [
        f"// {service_name}_client.go — generated from {service_name}.idl by",
        "// jubatus_tpu.codegen (--lang go). *** DO NOT EDIT ***",
        "package jubatus_tpu",
        "",
        "import (",
        '\t"time"',
        ")",
        "",
    ]
    for msg in idl.messages:
        out.append(f"type {_camel(msg.name)} struct {{")
        out.append("\t_msgpack struct{} `msgpack:\",as_array\"`")
        for f in sorted(msg.fields, key=lambda f: f.index):
            out.append(f"\t{_camel(f.name)} {_go_type(f.type)} "
                       f"`msgpack:\"{f.name}\"`")
        out.append("}")
        out.append("")
    out.append(f"type {cls} struct {{")
    out.append("\tClientBase")
    out.append("}")
    out.append("")
    out.append(f"func New{cls}(host string, port int, name string, "
               f"timeout time.Duration) (*{cls}, error) {{")
    out.append("\tbase, err := NewClientBase(host, port, name, timeout)")
    out.append("\tif err != nil {")
    out.append("\t\treturn nil, err")
    out.append("\t}")
    out.append(f"\treturn &{cls}{{ClientBase: *base}}, nil")
    out.append("}")
    out.append("")
    svc = idl.service(service_name)
    for d in svc.methods:
        params = ", ".join(f"{a.name} {_go_type(a.type)}" for a in d.args)
        callargs = ", ".join(a.name for a in d.args)
        routing = d.routing + (f"({d.cht_n})" if d.routing == "cht" else "")
        out.append(f"// {_camel(d.name)}: #{routing} #{d.lock} #{d.aggregator}")
        if d.return_type.strip() == "void":
            out.append(f"func (c *{cls}) {_camel(d.name)}({params}) error {{")
            out.append(f'\treturn c.Call("{d.name}", '
                       f"[]interface{{}}{{{callargs}}}, nil)")
            out.append("}")
        else:
            ret = _go_type(d.return_type)
            out.append(f"func (c *{cls}) {_camel(d.name)}({params}) "
                       f"({ret}, error) {{")
            out.append(f"\tvar out {ret}")
            out.append(f'\terr := c.Call("{d.name}", '
                       f"[]interface{{}}{{{callargs}}}, &out)")
            out.append("\treturn out, err")
            out.append("}")
        out.append("")
    return {
        f"{service_name}_client.go": "\n".join(out),
        "client.go": GO_COMMON,
    }
