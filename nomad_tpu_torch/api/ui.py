"""Embedded web UI.

The reference ships an Ember app (`ui/`, ~15k LoC) built into the
binary and served by the agent. Here a dependency-free single-page app
rides the same HTTP agent at /ui, consuming the public JSON API
(/v1/jobs, /v1/nodes, /v1/allocations, /v1/services, ...): cluster
overview, jobs with drill-down into groups/allocations/evaluations/
deployments, nodes with attributes and running allocs, and the service
catalog. Hash-routed, auto-refreshing, ACL-token aware.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>nomad-tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
:root {
  --bg: #f6f7f9; --panel: #fff; --ink: #1f2d3d; --sub: #6b7a90;
  --line: #e3e8ee; --green: #2eb039; --red: #c7384c; --amber: #d9a514;
  --blue: #1563ff;
}
* { box-sizing: border-box; }
body { margin: 0; font: 14px/1.5 -apple-system, "Segoe UI", Roboto,
       Helvetica, Arial, sans-serif; background: var(--bg);
       color: var(--ink); }
header { background: #161d26; color: #fff; padding: 10px 20px;
         display: flex; align-items: center; gap: 18px; }
header .brand { font-weight: 700; letter-spacing: .4px; }
header a { color: #c8d2e0; text-decoration: none; padding: 4px 8px;
           border-radius: 4px; }
header a.active, header a:hover { color: #fff; background: #273447; }
header .spacer { flex: 1; }
header input { background:#273447; border:1px solid #3a4a61;
               color:#fff; border-radius:4px; padding:4px 8px; }
main { max-width: 1100px; margin: 18px auto; padding: 0 16px; }
h1 { font-size: 20px; margin: 8px 0 14px; }
h2 { font-size: 15px; margin: 18px 0 8px; color: var(--sub);
     text-transform: uppercase; letter-spacing: .6px; }
table { width: 100%; border-collapse: collapse; background: var(--panel);
        border: 1px solid var(--line); border-radius: 6px;
        overflow: hidden; }
th, td { text-align: left; padding: 8px 12px;
         border-bottom: 1px solid var(--line); }
th { background: #fbfcfd; color: var(--sub); font-weight: 600;
     font-size: 12px; text-transform: uppercase; letter-spacing: .5px; }
tr:last-child td { border-bottom: 0; }
tr.row { cursor: pointer; }
tr.row:hover { background: #f0f4fa; }
.badge { display: inline-block; padding: 1px 8px; border-radius: 10px;
         font-size: 12px; font-weight: 600; color: #fff; }
.badge.running, .badge.ready, .badge.passing, .badge.complete,
.badge.successful, .badge.active { background: var(--green); }
.badge.pending, .badge.initializing, .badge.paused { background: var(--amber); }
.badge.failed, .badge.dead, .badge.down, .badge.critical,
.badge.lost, .badge.cancelled { background: var(--red); }
.badge.other { background: var(--sub); }
.cards { display: flex; gap: 12px; flex-wrap: wrap; margin: 12px 0; }
.card { background: var(--panel); border: 1px solid var(--line);
        border-radius: 6px; padding: 12px 18px; min-width: 130px; }
.card .num { font-size: 24px; font-weight: 700; }
.card .lbl { color: var(--sub); font-size: 12px;
             text-transform: uppercase; letter-spacing: .5px; }
.kv { background: var(--panel); border: 1px solid var(--line);
      border-radius: 6px; padding: 10px 14px; }
.kv div { display: flex; border-bottom: 1px solid var(--line);
          padding: 4px 0; }
.kv div:last-child { border-bottom: 0; }
.kv b { width: 240px; color: var(--sub); font-weight: 600; flex-shrink: 0; }
.err { background: #fdecec; border: 1px solid #f5c0c8; color: #8e1b2c;
       padding: 10px 14px; border-radius: 6px; margin: 10px 0; }
.muted { color: var(--sub); }
code { background: #eef1f5; padding: 1px 5px; border-radius: 3px; }
</style>
</head>
<body>
<header>
  <span class="brand">nomad-tpu</span>
  <a href="#/jobs" data-nav="jobs">Jobs</a>
  <a href="#/nodes" data-nav="nodes">Clients</a>
  <a href="#/allocations" data-nav="allocations">Allocations</a>
  <a href="#/services" data-nav="services">Services</a>
  <a href="#/topology" data-nav="topology">Topology</a>
  <span class="spacer"></span>
  <input id="token" placeholder="ACL token" size="18">
</header>
<main id="main">Loading&hellip;</main>
<script>
"use strict";
const $main = document.getElementById("main");
const $token = document.getElementById("token");
$token.value = localStorage.getItem("nomad_token") || "";
$token.addEventListener("change", () => {
  localStorage.setItem("nomad_token", $token.value); render();
});

async function api(path) {
  const headers = {};
  if ($token.value) headers["X-Nomad-Token"] = $token.value;
  const r = await fetch(path, { headers });
  if (!r.ok) {
    let msg = r.statusText;
    try { msg = (await r.json()).error || msg; } catch (e) {}
    throw new Error(`${r.status}: ${msg}`);
  }
  return r.json();
}

const esc = s => String(s ?? "").replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const short = id => esc(String(id || "").slice(0, 8));
function badge(status) {
  const known = ["running","ready","passing","complete","successful",
    "active","pending","initializing","paused","failed","dead","down",
    "critical","lost","cancelled"];
  const cls = known.includes(status) ? status : "other";
  return `<span class="badge ${cls}">${esc(status || "?")}</span>`;
}
function table(headers, rows, onclickPrefix) {
  const h = headers.map(x => `<th>${x}</th>`).join("");
  const b = rows.map(r => {
    // ids are user-controlled (job IDs are arbitrary strings):
    // URI-encode for the hash route, then HTML-escape for the attr
    const link = onclickPrefix && r._id ?
      ` class="row" data-href="${esc(onclickPrefix +
        encodeURIComponent(r._id))}"` : "";
    return `<tr${link}>` +
      r.cells.map(c => `<td>${c}</td>`).join("") + "</tr>";
  }).join("");
  return `<table><thead><tr>${h}</tr></thead><tbody>${b ||
    '<tr><td class="muted" colspan="' + headers.length +
    '">none</td></tr>'}</tbody></table>`;
}
const card = (n, l) =>
  `<div class="card"><div class="num">${n}</div>` +
  `<div class="lbl">${l}</div></div>`;
const kv = obj => '<div class="kv">' + Object.entries(obj).map(
  ([k, v]) => `<div><b>${esc(k)}</b><span>${v}</span></div>`
).join("") + "</div>";

// ---- views ---------------------------------------------------------
function jobsTable(jobs) {
  const rows = jobs.map(j => ({ _id: j.ID, cells: [
    esc(j.ID), badge(j.Status), esc(j.Type),
    String(j.Priority ?? "")] }));
  return table(["Job", "Status", "Type", "Priority"], rows, "#/jobs/");
}
async function viewJobs() {
  return `<h1>Jobs</h1>` + jobsTable(await api("/v1/jobs"));
}

async function viewJob(id) {
  const [job, allocs, evals] = await Promise.all([
    api(`/v1/job/${encodeURIComponent(id)}`),
    api(`/v1/job/${encodeURIComponent(id)}/allocations`),
    api(`/v1/job/${encodeURIComponent(id)}/evaluations`)]);
  let deployments = [];
  try { deployments =
    await api(`/v1/job/${encodeURIComponent(id)}/deployments`); }
  catch (e) {}
  const groups = (job.task_groups || []).map(g => ({ cells: [
    esc(g.name), String(g.count),
    (g.tasks || []).map(t => `<code>${esc(t.name)}</code> ` +
      `<span class="muted">${esc(t.driver)}</span>`).join(", ")] }));
  const arows = allocs.map(a => ({ _id: a.id, cells: [
    short(a.id), esc(a.task_group), badge(a.client_status),
    esc(a.desired_status), short(a.node_id)] }));
  const erows = evals.map(ev => ({ cells: [
    short(ev.id), badge(ev.status), esc(ev.triggered_by),
    esc(ev.type)] }));
  const drows = deployments.map(d => ({ cells: [
    short(d.id), badge(d.status),
    esc(d.status_description || "")] }));
  return `<h1>${esc(job.id)} ${badge(job.status)}</h1>` +
    kv({ Type: esc(job.type), Priority: job.priority,
         Namespace: esc(job.namespace), Region: esc(job.region),
         Datacenters: esc((job.datacenters || []).join(", ")),
         Version: job.version }) +
    `<h2>Task groups</h2>` +
    table(["Group", "Count", "Tasks"], groups) +
    `<h2>Allocations</h2>` +
    table(["ID", "Group", "Status", "Desired", "Node"], arows,
          "#/allocations/") +
    `<h2>Evaluations</h2>` +
    table(["ID", "Status", "Triggered by", "Type"], erows) +
    (drows.length ? `<h2>Deployments</h2>` +
      table(["ID", "Status", "Description"], drows) : "");
}

async function viewNodes() {
  const nodes = await api("/v1/nodes");
  const rows = nodes.map(n => ({ _id: n.id, cells: [
    esc(n.name), badge(n.status), esc(n.datacenter),
    `<span class="badge ${n.scheduling_eligibility === "eligible"
      ? "running" : "failed"}">${esc(n.scheduling_eligibility)}</span>`,
    n.drain ? badge("draining") : ""] }));
  return `<h1>Clients</h1>` +
    table(["Name", "Status", "DC", "Eligibility", "Drain"], rows,
          "#/nodes/");
}

async function viewNode(id) {
  const [node, allocs] = await Promise.all([
    api(`/v1/node/${encodeURIComponent(id)}`),
    api(`/v1/node/${encodeURIComponent(id)}/allocations`)]);
  const arows = allocs.map(a => ({ _id: a.id, cells: [
    short(a.id), esc(a.job_id), badge(a.client_status),
    esc(a.task_group)] }));
  const attrs = Object.entries(node.attributes || {}).sort()
    .map(([k, v]) => `<div><b>${esc(k)}</b><span>${esc(v)}</span></div>`)
    .join("");
  return `<h1>${esc(node.name)} ${badge(node.status)}</h1>` +
    kv({ ID: short(node.id), Datacenter: esc(node.datacenter),
         Class: esc(node.node_class || "-"),
         Drain: node.drain ? "yes" : "no",
         Eligibility: esc(node.scheduling_eligibility) }) +
    `<h2>Allocations</h2>` +
    table(["ID", "Job", "Status", "Group"], arows, "#/allocations/") +
    `<h2>Attributes</h2><div class="kv">${attrs}</div>`;
}

async function viewAllocs() {
  const allocs = await api("/v1/allocations");
  const rows = allocs.map(a => ({ _id: a.id, cells: [
    short(a.id), esc(a.job_id), esc(a.task_group),
    badge(a.client_status), esc(a.desired_status),
    short(a.node_id)] }));
  return `<h1>Allocations</h1>` +
    table(["ID", "Job", "Group", "Status", "Desired", "Node"], rows,
          "#/allocations/");
}

async function viewAlloc(id) {
  const a = await api(`/v1/allocation/${encodeURIComponent(id)}`);
  const tasks = Object.entries(a.task_states || {}).map(([name, ts]) =>
    ({ cells: [esc(name), badge(ts.state),
       String(ts.restarts || 0),
       (ts.events || []).slice(-3).map(e =>
         esc(e.type)).join(" → ")] }));
  return `<h1>Allocation ${short(a.id)} ` +
    `${badge(a.client_status)}</h1>` +
    kv({ Job: `<a href="#/jobs/${esc(a.job_id)}">${esc(a.job_id)}</a>`,
         "Task group": esc(a.task_group),
         Node: short(a.node_id),
         Desired: esc(a.desired_status),
         Name: esc(a.name) }) +
    `<h2>Tasks</h2>` +
    table(["Task", "State", "Restarts", "Recent events"], tasks);
}

async function viewServices() {
  const services = await api("/v1/services");
  const blocks = await Promise.all(services.map(async s => {
    const regs = await api(
      `/v1/service/${encodeURIComponent(s.ServiceName)}`);
    const rows = regs.map(r => ({ cells: [
      short(r.alloc_id), esc(r.task_name || "(group)"),
      `<code>${esc(r.address)}:${r.port}</code>`,
      badge(r.status)] }));
    return `<h2>${esc(s.ServiceName)} ` +
      `<span class="muted">${esc(s.Tags.join(", "))}</span></h2>` +
      table(["Alloc", "Task", "Address", "Health"], rows);
  }));
  return `<h1>Services</h1>` +
    (blocks.join("") || '<p class="muted">No registered services.</p>');
}

async function viewTopology() {
  const [nodes, allocs] = await Promise.all([
    api("/v1/nodes"), api("/v1/allocations")]);
  const byNode = {};
  for (const a of allocs) {
    if (a.client_status !== "running") continue;
    (byNode[a.node_id] = byNode[a.node_id] || []).push(a);
  }
  const rows = nodes.map(n => {
    const running = byNode[n.id] || [];
    const boxes = running.map(a =>
      `<span class="badge running" title="${esc(a.job_id)}">` +
      `${esc(a.job_id).slice(0, 10)}</span>`).join(" ");
    return { _id: n.id, cells: [esc(n.name), badge(n.status),
      String(running.length), boxes] };
  });
  const total = allocs.filter(
    a => a.client_status === "running").length;
  return `<h1>Topology</h1>` +
    `<div class="cards">${card(nodes.length, "clients")}` +
    `${card(total, "running allocs")}</div>` +
    table(["Client", "Status", "Allocs", "Jobs"], rows, "#/nodes/");
}

async function viewOverview() {
  const [jobs, nodes, allocs] = await Promise.all([
    api("/v1/jobs"), api("/v1/nodes"), api("/v1/allocations")]);
  const running = jobs.filter(j => j.Status === "running").length;
  const ready = nodes.filter(n => n.status === "ready").length;
  const live = allocs.filter(
    a => a.client_status === "running").length;
  return `<h1>Cluster</h1><div class="cards">` +
    card(jobs.length, "jobs") + card(running, "running jobs") +
    card(ready + "/" + nodes.length, "ready clients") +
    card(live, "running allocs") + `</div>` +
    `<h2>Jobs</h2>` + jobsTable(jobs);
}

// ---- router --------------------------------------------------------
const routes = [
  [/^#\\/jobs\\/(.+)$/, m => viewJob(decodeURIComponent(m[1]))],
  [/^#\\/jobs$/, () => viewJobs()],
  [/^#\\/nodes\\/(.+)$/, m => viewNode(decodeURIComponent(m[1]))],
  [/^#\\/nodes$/, () => viewNodes()],
  [/^#\\/allocations\\/(.+)$/,
   m => viewAlloc(decodeURIComponent(m[1]))],
  [/^#\\/allocations$/, () => viewAllocs()],
  [/^#\\/services$/, () => viewServices()],
  [/^#\\/topology$/, () => viewTopology()],
];

let renderSeq = 0;
async function render() {
  const seq = ++renderSeq;
  const hash = location.hash || "#/";
  document.querySelectorAll("header a").forEach(a => {
    a.classList.toggle("active",
      hash.startsWith("#/" + a.dataset.nav));
  });
  let view = viewOverview;
  let match = null;
  for (const [re, fn] of routes) {
    match = hash.match(re);
    if (match) { view = () => fn(match); break; }
  }
  try {
    const html = await view();
    if (seq === renderSeq) $main.innerHTML = html;
  } catch (e) {
    if (seq === renderSeq)
      $main.innerHTML = `<div class="err">${esc(e.message)}</div>`;
  }
}
document.addEventListener("click", e => {
  const tr = e.target.closest("tr[data-href]");
  if (tr) location.hash = tr.dataset.href;
});
window.addEventListener("hashchange", render);
render();
setInterval(() => {
  if (document.visibilityState === "visible") render();
}, 5000);
</script>
</body>
</html>
"""
