"""The port's UPnP client (`p2p/upnp.py`, `cli probe_upnp`) held against
the JAX package's on an in-process fake gateway: `tests/test_upnp.py`'s
eight cases, and the SSDP datagram and SOAP requests (method, path,
headers, body) of both packages byte for byte.

Everything runs on loopback: the fake gateway answers M-SEARCH on a UDP
port of 127.0.0.1 and serves the device description and the control URL
over HTTP there.  The cases that reach `probe`'s hairpin dial get an
external address of 127.0.0.1, so no packet leaves the host.
"""

import socket
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from tendermint_tpu.p2p import upnp as jupnp
from tendermint_tpu_torch.p2p import upnp

ROOT_DESC = """<?xml version="1.0"?>
<root xmlns="urn:schemas-upnp-org:device-1-0">
 <device>
  <deviceType>urn:schemas-upnp-org:device:InternetGatewayDevice:1</deviceType>
  <deviceList>
   <device>
    <deviceType>urn:schemas-upnp-org:device:WANDevice:1</deviceType>
    <deviceList>
     <device>
      <deviceType>urn:schemas-upnp-org:device:WANConnectionDevice:1</deviceType>
      <serviceList>
       <service>
        <serviceType>urn:schemas-upnp-org:service:WANIPConnection:1</serviceType>
        <controlURL>/ctl/IPConn</controlURL>
       </service>
      </serviceList>
     </device>
    </deviceList>
   </device>
  </deviceList>
 </device>
</root>"""

SOAP_EXT_IP = """<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/">
 <s:Body>
  <u:GetExternalIPAddressResponse
     xmlns:u="urn:schemas-upnp-org:service:WANIPConnection:1">
   <NewExternalIPAddress>{ip}</NewExternalIPAddress>
  </u:GetExternalIPAddressResponse>
 </s:Body>
</s:Envelope>"""

SOAP_OK = """<?xml version="1.0"?>
<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/">
 <s:Body><u:Resp xmlns:u="urn:schemas-upnp-org:service:WANIPConnection:1"/>
 </s:Body>
</s:Envelope>"""

DOC_IP = "203.0.113.7"          # a documentation address, never dialed


def _field(body: str, tag: str) -> str:
    return body.split(f"<{tag}>")[1].split("<")[0]


class FakeGateway:
    """SSDP UDP responder + device-description/SOAP HTTP server on
    loopback, keeping every request it was sent."""

    def __init__(self, external_ip: str = DOC_IP):
        self.mappings: dict[tuple[str, int], int] = {}
        self.soap_calls: list[str] = []
        self.datagrams: list[bytes] = []
        self.requests: list[tuple] = []    # (method, path, headers, body)
        gw = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", "text/xml")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _keep(self, body: bytes):
                heads = tuple((k, self.headers.get(k)) for k in (
                    "Content-Type", "User-Agent", "SOAPAction",
                    "Content-Length"))
                gw.requests.append((self.command, self.path, heads, body))

            def do_GET(self):
                self._keep(b"")
                if self.path == "/description.xml":
                    self._send(ROOT_DESC.encode())
                else:
                    self._send(b"not found", 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(n)
                self._keep(raw)
                body = raw.decode()
                action = self.headers.get("SOAPAction", "")
                gw.soap_calls.append(action)
                if "GetExternalIPAddress" in action:
                    self._send(SOAP_EXT_IP.format(ip=external_ip).encode())
                elif "AddPortMapping" in action:
                    key = (_field(body, "NewProtocol"),
                           int(_field(body, "NewExternalPort")))
                    gw.mappings[key] = int(_field(body, "NewInternalPort"))
                    self._send(SOAP_OK.encode())
                elif "DeletePortMapping" in action:
                    key = (_field(body, "NewProtocol"),
                           int(_field(body, "NewExternalPort")))
                    if key not in gw.mappings:
                        self._send(b"no such mapping", 500)
                        return
                    del gw.mappings[key]
                    self._send(SOAP_OK.encode())
                else:
                    self._send(b"unknown action", 500)

        self.http = HTTPServer(("127.0.0.1", 0), Handler)
        self.http_port = self.http.server_address[1]
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.bind(("127.0.0.1", 0))
        self.ssdp_addr = self.udp.getsockname()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self.http.serve_forever, daemon=True),
            threading.Thread(target=self._udp_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _udp_loop(self):
        self.udp.settimeout(0.2)
        while not self._stop.is_set():
            try:
                data, addr = self.udp.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            self.datagrams.append(data)
            if not data.startswith(b"M-SEARCH"):
                continue
            resp = ("HTTP/1.1 200 OK\r\n"
                    "CACHE-CONTROL: max-age=1800\r\n"
                    "ST: urn:schemas-upnp-org:device:"
                    "InternetGatewayDevice:1\r\n"
                    f"LOCATION: http://127.0.0.1:{self.http_port}"
                    "/description.xml\r\n\r\n")
            self.udp.sendto(resp.encode(), addr)

    def close(self):
        self._stop.set()
        self.http.shutdown()
        self.http.server_close()
        self.udp.close()


@pytest.fixture
def gateway():
    gw = FakeGateway()
    yield gw
    gw.close()


@pytest.fixture
def loopback_gateway():
    """A gateway whose external address is 127.0.0.1 (for `probe`)."""
    gw = FakeGateway(external_ip="127.0.0.1")
    yield gw
    gw.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_discover_finds_gateway(gateway):
    nat = upnp.discover(timeout=1.0, ssdp_addr=gateway.ssdp_addr)
    assert nat.service_url.endswith("/ctl/IPConn")
    assert nat.urn_domain == "schemas-upnp-org"
    assert nat.our_ip == "127.0.0.1"
    jnat = jupnp.discover(timeout=1.0, ssdp_addr=gateway.ssdp_addr)
    assert vars(nat) == vars(jnat)


def test_external_address(gateway):
    nat = upnp.discover(timeout=1.0, ssdp_addr=gateway.ssdp_addr)
    assert nat.get_external_address() == DOC_IP


def test_port_mapping_roundtrip(gateway):
    nat = upnp.discover(timeout=1.0, ssdp_addr=gateway.ssdp_addr)
    got = nat.add_port_mapping("tcp", 26656, 26656, "test", 0)
    assert got == 26656
    assert gateway.mappings == {("TCP", 26656): 26656}
    nat.delete_port_mapping("tcp", 26656)
    assert gateway.mappings == {}


def test_delete_unknown_mapping_raises(gateway):
    nat = upnp.discover(timeout=1.0, ssdp_addr=gateway.ssdp_addr)
    with pytest.raises(upnp.UPnPError):
        nat.delete_port_mapping("tcp", 4242)


def test_probe_reports_capabilities(loopback_gateway):
    port = _free_port()
    caps = upnp.probe(int_port=port, ext_port=port,
                      ssdp_addr=loopback_gateway.ssdp_addr)
    assert caps == {"port_mapping": True, "hairpin": True,
                    "external_ip": "127.0.0.1"}
    # the mapping was cleaned up after the probe
    assert loopback_gateway.mappings == {}
    kinds = [a.split("#")[-1].strip('"') for a in loopback_gateway.soap_calls]
    assert kinds == ["GetExternalIPAddress", "AddPortMapping",
                     "DeletePortMapping"]


def test_discover_no_responder_times_out():
    # a bound-but-silent UDP port: discovery must raise, not hang
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    try:
        with pytest.raises(upnp.UPnPError, match="discovery failed"):
            upnp.discover(timeout=0.3, ssdp_addr=s.getsockname())
    finally:
        s.close()


def test_external_listener_address(gateway):
    got = upnp.external_listener_address(26700, ssdp_addr=gateway.ssdp_addr)
    assert got is not None
    nat, addr = got
    assert addr == f"{DOC_IP}:26700"
    assert gateway.mappings == {("TCP", 26700): 26700}
    nat.delete_port_mapping("tcp", 26700)


def test_cli_probe_upnp(loopback_gateway, monkeypatch, capsys):
    from tendermint_tpu_torch.cli import main
    monkeypatch.setattr(upnp, "SSDP_ADDR", loopback_gateway.ssdp_addr)
    port = _free_port()
    rc = main(["probe_upnp", "--int-port", str(port), "--ext-port",
               str(port)])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.splitlines() == [
        "Probe success!",
        '{"port_mapping": true, "hairpin": true, "external_ip": '
        '"127.0.0.1"}']


def _session(mod, gw) -> tuple:
    """One discovery, an external-address query, a mapping and its
    deletion, and a failed deletion: what the gateway was sent."""
    nat = mod.discover(timeout=1.0, ssdp_addr=gw.ssdp_addr)
    answers = [nat.get_external_address(),
               nat.add_port_mapping("udp", 26656, 26657, "tm <node>", 3600)]
    nat.delete_port_mapping("udp", 26656)
    with pytest.raises(mod.UPnPError) as e:
        nat.delete_port_mapping("tcp", 1)
    answers.append(str(e.value))
    return gw.datagrams[:1], gw.requests, answers


def test_requests_byte_equal_jax():
    sent = []
    for mod in (upnp, jupnp):
        gw = FakeGateway()
        try:
            sent.append(_session(mod, gw))
        finally:
            gw.close()
    assert sent[0] == sent[1]
    datagrams, requests, answers = sent[0]
    assert datagrams == [upnp._MSEARCH] and upnp._MSEARCH == jupnp._MSEARCH
    assert [(m, p) for m, p, _, _ in requests] == [
        ("GET", "/description.xml")] + [("POST", "/ctl/IPConn")] * 4
    assert answers[:2] == [DOC_IP, 26656]
