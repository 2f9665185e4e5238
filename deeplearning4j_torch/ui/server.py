"""UIServer: HTTP view over attached StatsStorage instances (port of
``deeplearning4j_tpu/ui/server.py``: the same routes and JSON).

Reference: deeplearning4j-play PlayUIServer.java:53 (+ UIServer.java:24
singleton attach/detach) and the TrainModule overview route. Play+Scala
templates are replaced by Python's http.server with JSON endpoints and one
inline-JS overview page (no external dependencies):

- GET /train/sessions               -> session ids
- GET /train/overview?sid=...       -> score/time series + latest norms
- GET /train/model?sid=...          -> static model info
- GET /train/system?sid=...         -> memory / iterations-per-second series
- GET /train/histograms?sid=...     -> latest parameter histograms
- POST /remoteReceive               -> RemoteUIStatsStorageRouter sink
- GET /                             -> HTML overview (score chart via canvas)
- GET /model /system /histograms    -> HTML pages over the JSON endpoints
  (the TrainModule model/system/histogram tabs of deeplearning4j-play)
- POST /tsne/upload?sid=...         -> store 2-D embedding coords (+labels)
- GET /tsne/coords?sid=... /tsne    -> coords JSON / scatter page
  (the TsneModule of deeplearning4j-play, fed by plot.Tsne results)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from deeplearning4j_torch.ui.stats import TYPE_ID
from deeplearning4j_torch.ui.storage import InMemoryStatsStorage

_PAGE = """<!doctype html><html><head><title>dl4j-tpu training UI</title>
<style>body{font-family:sans-serif;margin:2em}canvas{border:1px solid #ccc}
table{border-collapse:collapse}td,th{border:1px solid #ddd;padding:4px 8px}
</style></head><body>
<p><a href="/">overview</a> | <a href="/model">model</a> |
<a href="/system">system</a> | <a href="/histograms">histograms</a></p>
<h2>Training overview</h2><div id="meta"></div>
<canvas id="score" width="800" height="300"></canvas>
<h3>Latest parameter norms</h3><table id="norms"></table>
<script>
async function refresh(){
 const sids=await (await fetch('/train/sessions')).json();
 if(!sids.length)return;
 const sid=sids[sids.length-1];
 const ov=await (await fetch('/train/overview?sid='+sid)).json();
 document.getElementById('meta').textContent=
   'session '+sid+' — '+ov.scores.length+' reports';
 const c=document.getElementById('score').getContext('2d');
 c.clearRect(0,0,800,300);
 const xs=ov.iterations, ys=ov.scores;
 if(xs.length>1){
  const ymax=Math.max(...ys), ymin=Math.min(...ys);
  c.beginPath();
  xs.forEach((x,i)=>{
   const px=40+(x-xs[0])/(xs[xs.length-1]-xs[0]||1)*740;
   const py=280-(ys[i]-ymin)/((ymax-ymin)||1)*260;
   i?c.lineTo(px,py):c.moveTo(px,py);});
  c.strokeStyle='#06c';c.stroke();
  c.fillText(ymax.toFixed(4),2,20);c.fillText(ymin.toFixed(4),2,285);
 }
 const t=document.getElementById('norms');
 t.innerHTML='<tr><th>param</th><th>L2 norm</th></tr>'+
  Object.entries(ov.latest_param_norms||{}).map(
   ([k,v])=>'<tr><td>'+k+'</td><td>'+v.toFixed(6)+'</td></tr>').join('');
}
refresh();setInterval(refresh,2000);
</script></body></html>"""

_NAV = ('<p><a href="/">overview</a> | <a href="/model">model</a> | '
        '<a href="/system">system</a> | <a href="/histograms">histograms</a>'
        ' | <a href="/tsne">tsne</a></p>')

_MODEL_PAGE = """<!doctype html><html><head><title>model</title>
<style>body{font-family:sans-serif;margin:2em}
table{border-collapse:collapse}td,th{border:1px solid #ddd;padding:4px 8px}
pre{background:#f6f6f6;padding:1em;max-width:60em;overflow:auto}
</style></head><body>""" + _NAV + """
<h2>Model</h2><table id="info"></table>
<h3>Configuration</h3><pre id="conf"></pre>
<script>
async function refresh(){
 const sids=await (await fetch('/train/sessions')).json();
 if(!sids.length)return;
 const m=await (await fetch('/train/model?sid='+sids[sids.length-1])).json();
 document.getElementById('info').innerHTML=
  Object.entries(m).filter(([k])=>k!='config_json').map(
   ([k,v])=>'<tr><th>'+k+'</th><td>'+JSON.stringify(v)+'</td></tr>').join('');
 try{document.getElementById('conf').textContent=
   JSON.stringify(JSON.parse(m.config_json||'{}'),null,2);}catch(e){}
}
refresh();
</script></body></html>"""

_SYSTEM_PAGE = """<!doctype html><html><head><title>system</title>
<style>body{font-family:sans-serif;margin:2em}canvas{border:1px solid #ccc}
</style></head><body>""" + _NAV + """
<h2>System</h2>
<h3>Host memory (RSS, MB)</h3><canvas id="mem" width="800" height="220"></canvas>
<h3>Iterations / second</h3><canvas id="ips" width="800" height="220"></canvas>
<h3>Training phases (ms per round)
<span style="color:#06c">host batch-prep</span> /
<span style="color:#c60">device round (incl. averaging)</span></h3>
<canvas id="phases" width="800" height="220"></canvas>
<script>
function line(id,xs,ys,color,clear=true,yminO=null,ymaxO=null){
 const c=document.getElementById(id).getContext('2d');
 if(clear)c.clearRect(0,0,800,220);
 const pairs=xs.map((x,i)=>[x,ys[i]]).filter(p=>p[1]!=null);
 if(pairs.length<2)return;
 const vy=pairs.map(p=>p[1]);
 const ymax=ymaxO!=null?ymaxO:Math.max(...vy);
 const ymin=yminO!=null?yminO:Math.min(...vy);
 const x0=pairs[0][0],x1=pairs[pairs.length-1][0];
 c.beginPath();
 pairs.forEach((p,i)=>{
  const px=40+(p[0]-x0)/((x1-x0)||1)*740;
  const py=200-(p[1]-ymin)/((ymax-ymin)||1)*180;
  i?c.lineTo(px,py):c.moveTo(px,py);});
 c.strokeStyle=color||'#06c';c.stroke();
 if(clear){c.fillText(ymax.toFixed(2),2,20);c.fillText(ymin.toFixed(2),2,205);}
}
async function refresh(){
 const sids=await (await fetch('/train/sessions')).json();
 if(!sids.length)return;
 const s=await (await fetch('/train/system?sid='+sids[sids.length-1])).json();
 line('mem',s.iterations,s.memory_mb);
 line('ips',s.iterations.slice(1),s.iterations_per_second.slice(1));
 // shared y-scale: the chart exists to COMPARE host prep vs device
 // round, so both series must map ms to pixels identically
 const pv=[...s.host_prep_ms,...s.device_round_ms].filter(v=>v!=null);
 if(pv.length){
  const pmin=Math.min(...pv),pmax=Math.max(...pv);
  line('phases',s.iterations,s.host_prep_ms,'#06c',true,pmin,pmax);
  line('phases',s.iterations,s.device_round_ms,'#c60',false,pmin,pmax);
 }
}
refresh();setInterval(refresh,2000);
</script></body></html>"""

_HISTOGRAM_PAGE = """<!doctype html><html><head><title>histograms</title>
<style>body{font-family:sans-serif;margin:2em}canvas{border:1px solid #ccc;
margin:4px}</style></head><body>""" + _NAV + """
<h2>Parameter histograms (latest report)</h2><div id="charts"></div>
<script>
async function refresh(){
 const sids=await (await fetch('/train/sessions')).json();
 if(!sids.length)return;
 const h=await (await fetch('/train/histograms?sid='+
                            sids[sids.length-1])).json();
 const root=document.getElementById('charts');root.innerHTML='';
 Object.entries(h.param_histograms||{}).forEach(([name,hist])=>{
  const div=document.createElement('div');
  div.innerHTML='<h4>'+name+' ['+hist.min.toFixed(4)+', '+
    hist.max.toFixed(4)+']</h4>';
  const cv=document.createElement('canvas');cv.width=420;cv.height=120;
  div.appendChild(cv);root.appendChild(div);
  const c=cv.getContext('2d');
  const n=hist.counts.length,m=Math.max(...hist.counts)||1;
  hist.counts.forEach((v,i)=>{
   c.fillStyle='#06c';
   c.fillRect(i*(420/n),120-v/m*110,(420/n)-1,v/m*110);});
 });
}
refresh();setInterval(refresh,3000);
</script></body></html>"""


_TSNE_PAGE = """<!doctype html><html><head><title>tsne</title>
<style>body{font-family:sans-serif;margin:2em}canvas{border:1px solid #ccc}
</style></head><body>""" + _NAV + """
<h2>t-SNE embedding</h2><div id="meta"></div>
<canvas id="plot" width="700" height="700"></canvas>
<script>
async function refresh(){
 const sids=await (await fetch('/tsne/sessions')).json();
 if(!sids.length)return;
 const sid=sids[sids.length-1];
 const d=await (await fetch('/tsne/coords?sid='+sid)).json();
 const pts=d.points||[];
 document.getElementById('meta').textContent=
   'session '+sid+' — '+pts.length+' points';
 if(!pts.length)return;
 const c=document.getElementById('plot').getContext('2d');
 c.clearRect(0,0,700,700);
 const xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
 const x0=Math.min(...xs),x1=Math.max(...xs),
       y0=Math.min(...ys),y1=Math.max(...ys);
 const colors=['#06c','#c60','#090','#909','#a00','#0aa','#660','#555'];
 const groups={};(d.labels||[]).forEach((l,i)=>{groups[l]=groups[l]??
   Object.keys(groups).length;});
 pts.forEach((p,i)=>{
  const px=20+(p[0]-x0)/((x1-x0)||1)*660;
  const py=680-(p[1]-y0)/((y1-y0)||1)*660;
  c.fillStyle=colors[(groups[(d.labels||[])[i]]||0)%colors.length];
  c.beginPath();c.arc(px,py,2.5,0,6.3);c.fill();
  if(pts.length<=200&&d.labels)c.fillText(d.labels[i],px+4,py);});
}
refresh();setInterval(refresh,5000);
</script></body></html>"""


class UIServer:
    """Singleton-ish server (reference: UIServer.getInstance())."""

    _instance = None

    @classmethod
    def get_instance(cls) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer()
        return cls._instance

    def __init__(self, port: int = 0):
        self.storages: list = []
        self._remote_sink = InMemoryStatsStorage()
        self._tsne: dict = {}  # session id -> {"points": ..., "labels": ...}
        self._httpd = None
        self._thread = None
        self._port = port

    # ------------------------------------------------------------- lifecycle
    def attach(self, storage) -> None:
        if storage not in self.storages:
            self.storages.append(storage)

    def detach(self, storage) -> None:
        if storage in self.storages:
            self.storages.remove(storage)

    def enable_remote_listener(self) -> None:
        """Accept POSTed records on /remoteReceive (reference:
        RemoteReceiverModule)."""
        self.attach(self._remote_sink)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else self._port

    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, status=200):
                body = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _html(self, page: str):
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                sid = q.get("sid", [None])[0]
                pages = {"/": _PAGE, "/model": _MODEL_PAGE,
                         "/system": _SYSTEM_PAGE,
                         "/histograms": _HISTOGRAM_PAGE,
                         "/tsne": _TSNE_PAGE}
                if u.path in pages:
                    self._html(pages[u.path])
                elif u.path == "/train/sessions":
                    self._json(server.list_sessions())
                elif u.path == "/tsne/sessions":
                    self._json(sorted(server._tsne))
                elif u.path == "/tsne/coords":
                    self._json(server._tsne.get(sid, {}))
                elif u.path == "/train/overview":
                    self._json(server.overview(sid))
                elif u.path == "/train/model":
                    self._json(server.model_info(sid))
                elif u.path == "/train/system":
                    self._json(server.system_info(sid))
                elif u.path == "/train/histograms":
                    self._json(server.histograms(sid))
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                u = urlparse(self.path)
                if u.path == "/tsne/upload":
                    sid = parse_qs(u.query).get("sid", ["default"])[0]
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        msg = json.loads(self.rfile.read(n))
                        server.upload_tsne(sid, msg.get("points", []),
                                           msg.get("labels"))
                    except (ValueError, TypeError, IndexError,
                            KeyError) as e:
                        self._json({"error": f"bad payload: {e}"}, 400)
                        return
                    self._json({"status": "ok"})
                    return
                if u.path != "/remoteReceive":
                    self._json({"error": "not found"}, 404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                msg = json.loads(self.rfile.read(n))
                sink = server._remote_sink
                {"static": sink.put_static_info,
                 "update": sink.put_update,
                 "meta": sink.put_storage_metadata}[msg["kind"]](
                     msg["record"])
                self._json({"status": "ok"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # ----------------------------------------------------------------- views
    def list_sessions(self) -> list:
        out = []
        for s in self.storages:
            out.extend(s.list_session_ids())
        return sorted(set(out))

    def overview(self, session_id) -> dict:
        iters, scores, latest = [], [], None
        for s in self.storages:
            for r in s.get_all_updates_after(session_id, TYPE_ID):
                iters.append(r["data"].get("iteration"))
                scores.append(r["data"].get("score"))
                latest = r
        return {"iterations": iters, "scores": scores,
                "latest_param_norms":
                    latest["data"].get("param_norms") if latest else {},
                "latest_update_norms":
                    latest["data"].get("update_norms") if latest else {}}

    def model_info(self, session_id) -> dict:
        for s in self.storages:
            r = s.get_static_info(session_id, TYPE_ID)
            if r:
                return r["data"]
        return {}

    def system_info(self, session_id) -> dict:
        """Memory / throughput / phase-timing series (reference:
        TrainModule system tab + SparkTrainingStats' per-round
        data-fetch/fit timings)."""
        iters, mem, ips, prep, dev = [], [], [], [], []
        for s in self.storages:
            for r in s.get_all_updates_after(session_id, TYPE_ID):
                iters.append(r["data"].get("iteration"))
                mem.append(
                    (r["data"].get("memory_rss_bytes") or 0) / 1e6)
                ips.append(r["data"].get("iterations_per_second"))
                pt = r["data"].get("phase_timings") or {}
                prep.append(pt.get("host_prep_ms"))
                dev.append(pt.get("device_round_ms"))
        return {"iterations": iters, "memory_mb": mem,
                "iterations_per_second": ips,
                "host_prep_ms": prep, "device_round_ms": dev}

    # bounds for HTTP-uploaded embeddings: the UI port is reachable by any
    # local process, so memory growth must be capped (oldest session is
    # evicted, matching the rolling character of the stats storages)
    TSNE_MAX_POINTS = 200_000
    TSNE_MAX_SESSIONS = 32

    def upload_tsne(self, session_id, points, labels=None) -> None:
        """Store a 2-D embedding for the /tsne page (reference: TsneModule
        of deeplearning4j-play, which accepts uploaded coordinate files).
        ``points``: [N,2] array-like; ``labels``: optional length-N list.
        Typical source: ``plot.Tsne(...).fit(vectors)``."""
        if len(points) > self.TSNE_MAX_POINTS:
            raise ValueError(
                f"too many points ({len(points)} > {self.TSNE_MAX_POINTS})")
        if labels is not None and len(labels) != len(points):
            raise ValueError(
                f"labels length {len(labels)} != points length {len(points)}")
        pts = [[float(p[0]), float(p[1])] for p in points]
        # eviction below is least-recently-UPDATED: re-uploading an
        # existing session must refresh its position, or the actively
        # updated session gets evicted while stale ones survive
        self._tsne.pop(str(session_id), None)
        self._tsne[str(session_id)] = {
            "points": pts,
            "labels": [str(l) for l in labels] if labels is not None
            else None,
        }
        while len(self._tsne) > self.TSNE_MAX_SESSIONS:
            self._tsne.pop(next(iter(self._tsne)))

    def histograms(self, session_id) -> dict:
        """Latest collected parameter histograms (reference: TrainModule
        histogram tab; collected by StatsListener(collect_histograms=True)).
        'Latest' = max (timestamp, iteration) across ALL attached storages —
        attach order must not let a stale storage shadow a live one."""
        latest, latest_key = None, None
        for s in self.storages:
            for r in s.get_all_updates_after(session_id, TYPE_ID):
                if not r["data"].get("param_histograms"):
                    continue
                key = (r.get("timestamp", 0),
                       r["data"].get("iteration") or 0)
                if latest_key is None or key > latest_key:
                    latest, latest_key = r, key
        return {"iteration": latest["data"]["iteration"] if latest else None,
                "param_histograms":
                    latest["data"]["param_histograms"] if latest else {}}
