/* Interactive spectra scroller: timeline scrubber, playback, fading trails.
 *
 * "Extract Slice" tears down the UI and leaves a copyable
 * `.isel({dim: idx})` snippet, preserving pipeline lineage.
 */

export function render({ model, el }) {
  const dpr = window.devicePixelRatio || 1;
  const W = model.get("width");
  const H = model.get("height");

  const root = document.createElement("div");
  root.className = "xsc-root";
  root.style.width = W + "px";

  const stage = document.createElement("div");
  stage.className = "xsc-stage";
  stage.style.width = W + "px";
  stage.style.height = H + "px";
  const canvas = document.createElement("canvas");
  canvas.width = W * dpr;
  canvas.height = H * dpr;
  canvas.style.width = W + "px";
  canvas.style.height = H + "px";
  stage.appendChild(canvas);

  const bar = document.createElement("div");
  bar.className = "xsc-bar";

  const playBtn = document.createElement("button");
  playBtn.className = "xsc-btn";
  playBtn.textContent = "▶";

  const slider = document.createElement("input");
  slider.type = "range";
  slider.className = "xsc-slider";
  slider.min = 0;
  slider.step = 1;

  const counter = document.createElement("span");
  counter.className = "xsc-counter";

  const extractBtn = document.createElement("button");
  extractBtn.className = "xsc-btn remove-me-close-btn";
  extractBtn.textContent = "Extract Slice";

  bar.append(playBtn, slider, counter, extractBtn);
  root.append(stage, bar);
  el.appendChild(root);

  // ---- Data ---------------------------------------------------------------
  const X = model.get("x_coords");
  const S = model.get("spectra");
  const nScroll = S.length;
  slider.max = nScroll - 1;

  const xlim = model.get("xlim");
  const ylim = model.get("ylim");
  const xMin = xlim.length === 2 ? Math.min(...xlim) : Math.min(...X);
  const xMax = xlim.length === 2 ? Math.max(...xlim) : Math.max(...X);
  let yMin = Infinity, yMax = -Infinity;
  if (ylim.length === 2) {
    yMin = ylim[0]; yMax = ylim[1];
  } else {
    for (const row of S) for (const v of row) {
      if (v < yMin) yMin = v;
      if (v > yMax) yMax = v;
    }
  }
  const yPad = (yMax - yMin || 1) * 0.05;
  yMin -= yPad; yMax += yPad;

  const margin = { l: 48, r: 12, t: 10, b: 34 };
  const pw = W - margin.l - margin.r;
  const ph = H - margin.t - margin.b;
  const toX = (v) => margin.l + ((xMax - v) / (xMax - xMin || 1)) * pw;
  const toY = (v) => margin.t + ph * (1 - (v - yMin) / (yMax - yMin || 1));

  const ctx = canvas.getContext("2d");
  ctx.scale(dpr, dpr);

  function drawRow(row, color, width) {
    ctx.strokeStyle = color;
    ctx.lineWidth = width;
    ctx.beginPath();
    let started = false;
    for (let i = 0; i < X.length; i++) {
      if (X[i] < xMin || X[i] > xMax) continue;
      const x = toX(X[i]), y = toY(row[i]);
      if (!started) { ctx.moveTo(x, y); started = true; } else ctx.lineTo(x, y);
    }
    ctx.stroke();
  }

  function draw() {
    const idx = model.get("current_index");
    ctx.clearRect(0, 0, W, H);
    ctx.strokeStyle = "#999";
    ctx.strokeRect(margin.l, margin.t, pw, ph);

    ctx.save();
    ctx.beginPath();
    ctx.rect(margin.l, margin.t, pw, ph);
    ctx.clip();

    // fading history trails
    if (model.get("show_trace")) {
      const count = model.get("trace_count");
      for (let back = count; back >= 1; back--) {
        const j = idx - back;
        if (j < 0) continue;
        const alpha = 0.35 * (1 - back / (count + 1));
        drawRow(S[j], `rgba(90, 120, 200, ${alpha.toFixed(3)})`, 1.0);
      }
    }
    drawRow(S[idx], "#111", 1.6);
    ctx.restore();

    ctx.fillStyle = "#333";
    ctx.font = "12px sans-serif";
    ctx.textAlign = "center";
    ctx.fillText(model.get("x_label"), margin.l + pw / 2, H - 10);

    counter.textContent = `${model.get("scroll_dim")}: ${idx} / ${nScroll - 1}`;
    slider.value = idx;
  }

  const setIndex = (i) => {
    const clamped = Math.max(0, Math.min(nScroll - 1, i));
    model.set("current_index", clamped);
    model.save_changes();
    draw();
  };

  slider.addEventListener("input", () => setIndex(parseInt(slider.value, 10)));
  canvas.addEventListener("wheel", (ev) => {
    ev.preventDefault();
    setIndex(model.get("current_index") + (ev.deltaY > 0 ? 1 : -1));
  });

  let timer = null;
  playBtn.onclick = () => {
    if (timer) {
      clearInterval(timer);
      timer = null;
      playBtn.textContent = "▶";
    } else {
      playBtn.textContent = "❚❚";
      timer = setInterval(() => {
        setIndex((model.get("current_index") + 1) % nScroll);
      }, 120);
    }
  };

  extractBtn.onclick = () => {
    if (timer) clearInterval(timer);
    const idx = model.get("current_index");
    const dim = model.get("scroll_dim");
    const snippet = `slice_da = da.isel({"${dim}": ${idx}})`;
    root.innerHTML =
      `<div class='xsc-done'><div class='xsc-done-title'>Slice extracted — ` +
      `reproduce with:</div><pre class='xsc-snippet'>${snippet}</pre></div>`;
    const pre = root.querySelector(".xsc-snippet");
    pre.onclick = () => navigator.clipboard && navigator.clipboard.writeText(snippet);
  };

  model.on("change:current_index", draw);
  draw();
}
