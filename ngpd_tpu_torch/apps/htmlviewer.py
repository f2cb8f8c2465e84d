"""Self-contained HTML mesh viewer (numpy and strings), a copy of
``ngpd_tpu/apps/htmlviewer.py``: the same arrays give the same bytes.

The viewer is the interactive remainder of the
reference's Qt/OpenGL MeshViewer (MeshViewer.cpp:219-532, error-map
coloring 1344-1377) without a GUI toolkit or a server.

``export_html`` writes ONE .html file embedding the geometry (base64
Float32Arrays) and a ~100-line vanilla WebGL renderer with orbit/zoom
controls and Lambert shading. No external assets, no CDN — the file
opens from disk anywhere. Vertex colors (e.g.
``meshproc.metrics.error_map_colors``) ride along when given;
otherwise a neutral gray is used.

Point clouds render as GL_POINTS when ``faces`` is None.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Union

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#181a1f;color:#ccc;font:12px monospace}
#hud{position:fixed;left:8px;top:8px;user-select:none}
canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud">__TITLE__ — drag: orbit, wheel: zoom, dbl-click: reset</div>
<canvas id="c"></canvas>
<script>
"use strict";
const META = __META__;
function decode(b64){const s=atob(b64);const a=new Uint8Array(s.length);
  for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
const pos = decode("__POS__");
const col = decode("__COL__");
const nrm = META.points ? null : decode("__NRM__");
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
const vsrc = `attribute vec3 p; attribute vec3 n; attribute vec3 c;
uniform mat4 mvp; uniform mat4 mv; varying vec3 vn; varying vec3 vc;
void main(){ gl_Position = mvp*vec4(p,1.0); gl_PointSize = 2.0;
  vn = mat3(mv[0].xyz,mv[1].xyz,mv[2].xyz)*n; vc = c; }`;
const fsrc = `precision mediump float; varying vec3 vn; varying vec3 vc;
void main(){ float l = ${META.points ? "1.0" :
  "0.25 + 0.75*abs(normalize(vn).z)"}; gl_FragColor = vec4(vc*l,1.0); }`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);
  if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vsrc));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fsrc));
gl.linkProgram(prog); gl.useProgram(prog);
function attr(name,data){const b=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);
  const a=gl.getAttribLocation(prog,name);
  if(a>=0){gl.enableVertexAttribArray(a);gl.vertexAttribPointer(a,3,gl.FLOAT,false,0,0);}}
attr("p",pos); attr("c",col); if(nrm) attr("n",nrm);
gl.enable(gl.DEPTH_TEST);
let yaw=0.6,pitch=0.4,dist=2.4,drag=null;
canvas.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY]);
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008; pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.55,Math.min(1.55,pitch)); drag=[e.clientX,e.clientY];});
canvas.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);
  dist=Math.max(0.3,Math.min(20,dist)); e.preventDefault()},{passive:false});
canvas.addEventListener("dblclick",()=>{yaw=0.6;pitch=0.4;dist=2.4;});
function mat(){
  const a=window.innerWidth/window.innerHeight,f=1.0/Math.tan(0.4),zn=0.01,zf=100;
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  // model-view: rotate yaw about Y then pitch about X, translate -dist.
  const mv=[cy,sy*sp,sy*cp,0, 0,cp,-sp,0, -sy,cy*sp,cy*cp,0, 0,0,-dist,1];
  const pr=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
  // mvp = pr * mv (column-major 4x4 multiply)
  const o=new Array(16).fill(0);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
    o[j*4+i]+=pr[k*4+i]*mv[j*4+k];
  return [new Float32Array(o), new Float32Array(mv)];
}
function frame(){
  canvas.width=window.innerWidth*devicePixelRatio;
  canvas.height=window.innerHeight*devicePixelRatio;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.clearColor(0.094,0.102,0.122,1); gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const [mvp,mv]=mat();
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,"mvp"),false,mvp);
  gl.uniformMatrix4fv(gl.getUniformLocation(prog,"mv"),false,mv);
  gl.drawArrays(META.points?gl.POINTS:gl.TRIANGLES,0,pos.length/3);
  requestAnimationFrame(frame);
}
frame();
</script></body></html>
"""


def _b64(a: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(a, np.float32).tobytes()
    ).decode("ascii")


def export_html(
    path: Union[str, Path],
    vertices: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
    title: str = "ngpd_tpu mesh",
) -> Path:
    """Write a standalone orbit-viewer .html for a mesh or point cloud.

    ``colors``: per-vertex RGB in [0, 1] (error_map_colors output) —
    optional. Returns the written path.
    """
    v = np.asarray(vertices, np.float32)
    # Normalize into the unit view box (the C++ app's load
    # normalization, MeshViewer.cpp:101-131).
    center = (v.min(0) + v.max(0)) / 2.0
    scale = float(max(v.max(0) - v.min(0)))
    v = (v - center) / max(scale, 1e-30)
    if colors is None:
        colors = np.full_like(v, 0.72)
    colors = np.asarray(colors, np.float32)

    if faces is None:
        pos, col, nrm = v, colors, None
    else:
        f = np.asarray(faces, np.int64)
        # Flat shading: duplicate vertices per face so each triangle
        # carries its own face normal.
        tri = v[f]  # (F, 3, 3)
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        fn /= np.maximum(
            np.linalg.norm(fn, axis=1, keepdims=True), 1e-30
        )
        pos = tri.reshape(-1, 3)
        nrm = np.repeat(fn, 3, axis=0)
        col = colors[f].reshape(-1, 3)

    html = (
        _TEMPLATE.replace("__TITLE__", title)
        .replace("__META__", json.dumps({"points": faces is None}))
        .replace("__POS__", _b64(pos))
        .replace("__COL__", _b64(col))
        .replace("__NRM__", _b64(nrm) if nrm is not None else "")
    )
    path = Path(path)
    path.write_text(html)
    return path
