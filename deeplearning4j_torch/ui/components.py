"""Declarative UI components: charts/tables/text as data, rendered to a
standalone HTML page (port of
``deeplearning4j_tpu/ui/components.py``: the component JSON and the
rendered page, default title included, are the JAX package's, byte for
byte).

Reference: deeplearning4j-ui-components — Component.java type-tagged JSON
(ChartLine/ChartScatter/ChartHistogram/ChartHorizontalBar/ChartStackedArea,
ComponentTable/ComponentText/ComponentDiv, Style*) and
StaticPageUtil.renderHTML (freemarker template embedding the component
JSON + its JS renderers). Here: plain dataclasses with the same
``componentType`` tag discipline, and ``render_html`` emits one
self-contained page (inline canvas JS, zero external dependencies — the
reference pulls jquery/d3 from the classpath; offline machines can't).
DecoratorAccordion and ChartTimeline are out of scope (stated, not
stubbed).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import List, Optional

_REGISTRY = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class Style:
    width: float = 640
    height: float = 300
    margin_top: float = 30
    margin_bottom: float = 30
    margin_left: float = 50
    margin_right: float = 20


@dataclass
class StyleChart(Style):
    stroke_width: float = 1.5
    point_size: float = 3.0
    series_colors: List[str] = field(default_factory=lambda: [
        "#0066cc", "#cc3300", "#009933", "#9933cc", "#ff9900"])
    axis_stroke_width: float = 1.0
    title_font_size: float = 14


@dataclass
class StyleTable(Style):
    header_color: str = "#dddddd"
    border_width: float = 1.0
    column_widths: Optional[List[float]] = None


@dataclass
class StyleText(Style):
    font: str = "sans-serif"
    font_size: float = 13.0
    color: str = "#000000"


class Component:
    """Base: serialization with the reference's componentType tag."""

    def to_dict(self) -> dict:
        d = {"componentType": type(self).__name__}
        d.update(asdict(self))
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Component":
        d = json.loads(s)
        return Component.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "Component":
        d = dict(d)
        t = d.pop("componentType", None)
        cls = _REGISTRY.get(t)
        if cls is None:
            raise ValueError(f"Unknown componentType '{t}'")
        return cls._from_dict(d)

    @classmethod
    def _from_dict(cls, d: dict) -> "Component":
        style = d.pop("style", None)
        obj = cls(**d)
        if isinstance(style, dict):
            obj.style = cls._style_cls()(**style)
        elif style is not None:
            obj.style = style
        return obj

    @classmethod
    def _style_cls(cls):
        return StyleChart


@_register
@dataclass
class ChartLine(Component):
    """Multi-series line chart (reference: ChartLine.java)."""

    title: str = ""
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_series(self, name, xs, ys) -> "ChartLine":
        self.series_names.append(str(name))
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        return self


@_register
@dataclass
class ChartScatter(Component):
    """Multi-series scatter (reference: ChartScatter.java)."""

    title: str = ""
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    series_names: List[str] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_series(self, name, xs, ys) -> "ChartScatter":
        self.series_names.append(str(name))
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        return self


@_register
@dataclass
class ChartHistogram(Component):
    """Variable-bin histogram (reference: ChartHistogram.java —
    lowerBounds/upperBounds/yValues)."""

    title: str = ""
    lower_bounds: List[float] = field(default_factory=list)
    upper_bounds: List[float] = field(default_factory=list)
    y_values: List[float] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_bin(self, lower, upper, y) -> "ChartHistogram":
        self.lower_bounds.append(float(lower))
        self.upper_bounds.append(float(upper))
        self.y_values.append(float(y))
        return self


@_register
@dataclass
class ChartHorizontalBar(Component):
    """Horizontal bars (reference: ChartHorizontalBar.java)."""

    title: str = ""
    labels: List[str] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)


@_register
@dataclass
class ChartStackedArea(Component):
    """Stacked area chart (reference: ChartStackedArea.java): shared x,
    one y series per label, stacked cumulatively."""

    title: str = ""
    x: List[float] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    labels: List[str] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)


@_register
@dataclass
class ChartMatrix(Component):
    """Heatmap over a 2-D value grid (no direct reference analog as a
    component — the reference's ConvolutionalIterationListener renders
    activation grids server-side to PNG; here the grid is data and the
    page renders it, which also serves confusion matrices)."""

    title: str = ""
    values: List[List[float]] = field(default_factory=list)
    row_labels: List[str] = field(default_factory=list)
    col_labels: List[str] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)


@_register
@dataclass
class ComponentTable(Component):
    """Simple table (reference: ComponentTable.java)."""

    header: List[str] = field(default_factory=list)
    content: List[List[str]] = field(default_factory=list)
    style: StyleTable = field(default_factory=StyleTable)

    @classmethod
    def _style_cls(cls):
        return StyleTable


@_register
@dataclass
class ComponentText(Component):
    """Styled text block (reference: ComponentText.java)."""

    text: str = ""
    style: StyleText = field(default_factory=StyleText)

    @classmethod
    def _style_cls(cls):
        return StyleText


@_register
@dataclass
class ComponentDiv(Component):
    """Container of child components (reference: ComponentDiv.java)."""

    children: List[dict] = field(default_factory=list)
    style: Style = field(default_factory=Style)

    @classmethod
    def _style_cls(cls):
        return Style

    def add(self, *components: Component) -> "ComponentDiv":
        self.children.extend(c.to_dict() for c in components)
        return self


_RENDER_JS = r"""
function renderComponent(c, root){
 function amin(a){let m=Infinity;for(let i=0;i<a.length;i++)if(a[i]<m)m=a[i];return m;}
 function amax(a){let m=-Infinity;for(let i=0;i<a.length;i++)if(a[i]>m)m=a[i];return m;}
 function flat(xs){const o=[];xs.forEach(s=>{for(let i=0;i<s.length;i++)o.push(s[i]);});return o;}
 const t=c.componentType;
 if(t==='ComponentDiv'){
  const div=document.createElement('div');root.appendChild(div);
  (c.children||[]).forEach(ch=>renderComponent(ch,div));return;}
 if(t==='ComponentText'){
  const p=document.createElement('p');p.textContent=c.text;
  p.style.font=c.style.font_size+'px '+c.style.font;
  p.style.color=c.style.color;root.appendChild(p);return;}
 if(t==='ComponentTable'){
  const tb=document.createElement('table');tb.style.borderCollapse='collapse';
  const tr=document.createElement('tr');
  (c.header||[]).forEach(h=>{const th=document.createElement('th');
   th.textContent=h;th.style.background=c.style.header_color;
   th.style.border='1px solid #999';th.style.padding='3px 8px';
   tr.appendChild(th);});
  tb.appendChild(tr);
  (c.content||[]).forEach(row=>{const r=document.createElement('tr');
   row.forEach(v=>{const td=document.createElement('td');td.textContent=v;
    td.style.border='1px solid #ccc';td.style.padding='3px 8px';
    r.appendChild(td);});tb.appendChild(r);});
  root.appendChild(tb);return;}
 // charts share a canvas + axes
 const st=c.style,W=st.width,H=st.height;
 const l=st.margin_left,r=st.margin_right,tp=st.margin_top,b=st.margin_bottom;
 const h=document.createElement('h4');h.textContent=c.title||'';
 root.appendChild(h);
 const cv=document.createElement('canvas');cv.width=W;cv.height=H;
 cv.style.border='1px solid #ccc';root.appendChild(cv);
 const g=cv.getContext('2d');
 const pw=W-l-r,ph=H-tp-b;
 function axes(x0,x1,y0,y1){
  g.strokeStyle='#333';g.beginPath();g.moveTo(l,tp);g.lineTo(l,tp+ph);
  g.lineTo(l+pw,tp+ph);g.stroke();
  g.fillStyle='#333';
  g.fillText(y1.toPrecision(3),2,tp+8);g.fillText(y0.toPrecision(3),2,tp+ph);
  g.fillText(x0.toPrecision(3),l,H-4);g.fillText(x1.toPrecision(3),l+pw-30,H-4);}
 function px(v,x0,x1){return l+(v-x0)/((x1-x0)||1)*pw;}
 function py(v,y0,y1){return tp+ph-(v-y0)/((y1-y0)||1)*ph;}
 if(t==='ChartLine'||t==='ChartScatter'){
  const xs=flat(c.x),ys=flat(c.y);
  if(!xs.length)return;
  const x0=amin(xs),x1=amax(xs);
  const y0=amin(ys),y1=amax(ys);
  axes(x0,x1,y0,y1);
  c.x.forEach((sx,i)=>{
   const col=st.series_colors[i%st.series_colors.length];
   if(t==='ChartLine'){
    g.strokeStyle=col;g.lineWidth=st.stroke_width;g.beginPath();
    sx.forEach((v,j)=>{const X=px(v,x0,x1),Y=py(c.y[i][j],y0,y1);
     j?g.lineTo(X,Y):g.moveTo(X,Y);});
    g.stroke();
   }else{
    g.fillStyle=col;
    sx.forEach((v,j)=>{g.beginPath();
     g.arc(px(v,x0,x1),py(c.y[i][j],y0,y1),st.point_size,0,6.283);
     g.fill();});}
   g.fillStyle=col;
   g.fillText(c.series_names[i]||('s'+i),l+pw-80,tp+12+12*i);});
 }else if(t==='ChartHistogram'){
  if(!c.y_values.length)return;
  const x0=amin(c.lower_bounds),x1=amax(c.upper_bounds);
  const y1=amax(c.y_values);
  axes(x0,x1,0,y1);
  g.fillStyle=st.series_colors[0];
  c.y_values.forEach((v,i)=>{
   const X0=px(c.lower_bounds[i],x0,x1),X1=px(c.upper_bounds[i],x0,x1);
   g.fillRect(X0,py(v,0,y1),Math.max(X1-X0-1,1),tp+ph-py(v,0,y1));});
 }else if(t==='ChartHorizontalBar'){
  if(!c.values.length)return;
  const v1=Math.max(amax(c.values),0);
  const bh=ph/c.values.length;
  c.values.forEach((v,i)=>{
   g.fillStyle=st.series_colors[i%st.series_colors.length];
   g.fillRect(l,tp+i*bh+2,(v/(v1||1))*pw,bh-4);
   g.fillStyle='#333';g.fillText(c.labels[i]||'',2,tp+i*bh+bh/2);});
 }else if(t==='ChartStackedArea'){
  if(!c.x.length)return;
  const x0=amin(c.x),x1=amax(c.x);
  const sums=c.x.map((_,j)=>c.y.reduce((a,s)=>a+s[j],0));
  const y1=amax(sums);
  axes(x0,x1,0,y1);
  let base=c.x.map(()=>0);
  c.y.forEach((s,i)=>{
   const top=base.map((bv,j)=>bv+s[j]);
   g.fillStyle=st.series_colors[i%st.series_colors.length];
   g.beginPath();
   c.x.forEach((v,j)=>{const X=px(v,x0,x1),Y=py(top[j],0,y1);
    j?g.lineTo(X,Y):g.moveTo(X,Y);});
   for(let j=c.x.length-1;j>=0;j--)
    g.lineTo(px(c.x[j],x0,x1),py(base[j],0,y1));
   g.closePath();g.fill();
   g.fillStyle='#333';g.fillText(c.labels[i]||('s'+i),l+pw-80,tp+12+12*i);
   base=top;});
 }else if(t==='ChartMatrix'){
  const R=c.values.length;if(!R)return;
  const C=c.values[0].length;
  const vmin=amin(c.values.map(amin)),vmax=amax(c.values.map(amax));
  const cw=pw/C,chh=ph/R;
  for(let i=0;i<R;i++)for(let j=0;j<C;j++){
   const u=(c.values[i][j]-vmin)/((vmax-vmin)||1);
   const hue=240-240*u;  // blue (low) -> red (high)
   g.fillStyle='hsl('+hue+',80%,'+(30+40*u)+'%)';
   g.fillRect(l+j*cw,tp+i*chh,Math.ceil(cw),Math.ceil(chh));}
  g.fillStyle='#333';
  (c.row_labels||[]).forEach((s,i)=>g.fillText(s,2,tp+i*chh+chh/2));
  (c.col_labels||[]).forEach((s,j)=>g.fillText(s,l+j*cw,H-4));
  g.fillText(vmax.toPrecision(3)+' max',l+pw-70,tp+10);
  g.fillText(vmin.toPrecision(3)+' min',l+pw-70,tp+22);
 }
}
"""

_PAGE_TEMPLATE = """<!doctype html><html><head><meta charset="utf-8">
<title>{title}</title>
<style>body{{font-family:sans-serif;margin:2em}}</style></head><body>
<div id="root"></div>
<script>
const COMPONENTS = {data};
{render_js}
const root = document.getElementById('root');
COMPONENTS.forEach(c => renderComponent(c, root));
</script></body></html>"""


def render_html(components, title: str = "dl4j-tpu report") -> str:
    """Render components to ONE self-contained HTML page — data and
    renderer embedded (reference: StaticPageUtil.renderHTML)."""
    import html
    data = json.dumps([c.to_dict() if isinstance(c, Component) else c
                       for c in components])
    # '</script>' (or any '</') inside a string value would terminate the
    # script element mid-JSON and let component text inject markup;
    # '<\/' is identical to '</' to the JS parser but inert to the HTML one
    data = data.replace("</", "<\\/")
    return _PAGE_TEMPLATE.format(title=html.escape(title), data=data,
                                 render_js=_RENDER_JS)


def render_html_file(components, path: str,
                     title: str = "dl4j-tpu report") -> None:
    """render_html to a file (reference: StaticPageUtil.saveHTMLFile)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(render_html(components, title))
